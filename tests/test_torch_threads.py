"""The threaded deployment (`cfg.mapping.mapper_thread`, `System`'s mapper
thread with the global BA on a thread of its own) on the CPU.

- The mapper thread's local BA solves a snapshot with the map lock released
  (`Tracker._local_ba_off_lock`) and folds the result into the live map
  (`map_ba.fold_window_result`). On a seeded random map, the fold equals the
  benchmark's plain write-back (`slambench/reference/writeback.py`) bit for
  bit when nothing changed during the solve, when a keyframe was inserted
  and landmarks spawned, and when landmarks were culled and their slots
  reused; after a compaction the result is dropped and counted. The lock is
  free while the solve runs.
- The synchronous `_run_local_ba` still solves the live map in place, as
  the code before the mapper's snapshot did, on a short seeded orbit.
- The benchmark's threaded cell loads, its configuration selects the
  mapper thread and the asynchronous global BA, and `System` starts the
  mapper thread from it unless told otherwise.
- A threaded run records the frame's `track.lock_wait` spans and the
  mapper's `mapping.locked` intervals, with no mapper error.
- A reset or a new map made by the frame thread while the mapper's local
  BA solves drops the solve, and the keyframe's probe, merge detection and
  inertial back end do not run on its id of the old map.
- The cell's readers (`map_lock_wait_ms`, `mapper_locked_ms`,
  `gba_thread_ms` and the host-clock `pose_search_host_ms`,
  `mapper_step_host_ms`, `local_ba_host_ms`, `loop_close_host_ms`) on
  hand-made records, and nothing without spans.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from orbslam3lib_tpu_torch import system as tsys  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import StereoRig, render_stereo_sequence  # noqa: E402
from orbslam3lib_tpu_torch.mapping import local_mapping as lm_ops  # noqa: E402
from orbslam3lib_tpu_torch.mapping import map_ba  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as ms  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402
from orbslam3lib_tpu_torch.utils import lie  # noqa: E402
from slambench.harness import runner, spec  # noqa: E402
from slambench.harness.records import FrameRecord, RunRecords  # noqa: E402
from slambench.reference import writeback  # noqa: E402

from torch_parity import backend_config, orbit_frames  # noqa: E402

K, P, F = 12, 160, 24          # the random map's slots
N_KF, N_MP = 8, 120            # its live keyframes and landmarks
N_BA = 64                      # landmarks a window solve takes
WINDOW = torch.tensor([7, 6, 5, 4, 3, 2, -1, -1], dtype=torch.int32)
FIXED = torch.tensor([False, False, False, False, True, True, False, False])
THREAD_READERS = ("map_lock_wait_ms", "mapper_locked_ms", "gba_thread_ms",
                  "pose_search_host_ms", "mapper_step_host_ms", "local_ba_host_ms",
                  "loop_close_host_ms")


def random_cfg():
    cfg = SlamConfig()
    cfg.map.max_kf, cfg.map.max_mp, cfg.orb.max_kp = K, P, F
    cfg.camera.fx = cfg.camera.fy = 300.0
    cfg.camera.cx, cfg.camera.cy = 320.0, 200.0
    return cfg


def random_map(seed: int) -> ms.MapState:
    """A map of N_KF keyframes along a line, looking down +z, each seeing
    F of N_MP landmarks (half of them with stereo depth), observed with a
    pixel of noise; the poses and positions then moved off their truth so
    that a window solve moves them."""
    g = torch.Generator().manual_seed(seed)
    cfg = random_cfg()
    fx, fy, cx, cy = (float(v) for v in cfg.camera.params[:4])
    m = ms.empty_map(K, P, F)
    pts = torch.stack([torch.rand(N_MP, generator=g) * 4 - 2,
                       torch.rand(N_MP, generator=g) * 3 - 1.5,
                       torch.rand(N_MP, generator=g) * 3 + 3], 1)
    for k in range(N_KF):
        R = lie.so3_exp(torch.randn(3, generator=g) * 0.02)
        c = torch.tensor([0.1 * k, 0.0, 0.0]) + torch.randn(3, generator=g) * 0.01
        m.kf_R[k], m.kf_t[k], m.kf_valid[k] = R, -R @ c, True
        ids = torch.randperm(N_MP, generator=g)[:F]
        p = pts[ids] @ R.T + m.kf_t[k]
        uv = torch.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy], 1)
        m.kf_xy[k] = uv + torch.randn(F, 2, generator=g)
        m.kf_mp[k] = ids.to(torch.int32)
        m.kf_feat_valid[k] = True
        m.kf_level[k] = torch.randint(0, 4, (F,), generator=g, dtype=torch.int32)
        m.kf_depth[k] = torch.where(torch.arange(F) % 2 == 0, p[:, 2], torch.zeros(F))
    m.kf_t[:N_KF] += torch.randn(N_KF, 3, generator=g) * 0.01
    m.mp_pos[:N_MP] = pts + torch.randn(N_MP, 3, generator=g) * 0.02
    m.mp_valid[:N_MP] = True
    m.mp_first_kf[:N_MP] = torch.randint(0, N_KF, (N_MP,), generator=g, dtype=torch.int32)
    m.n_kf.fill_(N_KF)
    m.n_mp.fill_(N_MP)
    return m


def fields(m, names):
    return {k: getattr(m, k).clone() for k in names}


def insert_keyframe(m: ms.MapState, seed: int):
    """A keyframe made in between, spawning landmarks into free slots."""
    g = torch.Generator().manual_seed(seed)
    m.kf_valid[N_KF] = True
    m.kf_t[N_KF] = torch.tensor([-0.8, 0.0, 0.0])
    m.kf_mp[N_KF] = torch.arange(N_MP, N_MP + F, dtype=torch.int32)
    m.mp_valid[N_MP:N_MP + F] = True
    m.mp_pos[N_MP:N_MP + F] = torch.randn(F, 3, generator=g) + torch.tensor([0.0, 0.0, 4.0])
    m.mp_first_kf[N_MP:N_MP + F] = N_KF
    m.n_kf.fill_(N_KF + 1)
    m.n_mp.fill_(N_MP + F)


def cull_and_reuse(m: ms.MapState, seed: int):
    """Landmarks culled in between, half of their slots taken by new ones
    of a keyframe made meanwhile."""
    g = torch.Generator().manual_seed(seed)
    dead = torch.unique(m.kf_mp[WINDOW[0]].long())[:12]
    m.mp_valid[dead] = False
    reused = dead[::2]
    m.kf_valid[N_KF] = True
    m.mp_valid[reused] = True
    m.mp_pos[reused] = torch.randn(len(reused), 3, generator=g) + torch.tensor([0.0, 0.0, 4.0])
    m.mp_first_kf[reused] = N_KF


def run_off_lock(seed: int, change, monkeypatch):
    """`Tracker._local_ba_off_lock` over WINDOW of a random map, with
    `change(tracker)` run while the lock is released (after the solve, as
    the frame thread would meanwhile). Returns (tracker, the live map as
    the solve returned, the solved snapshot, whether another thread could
    take the lock during the solve)."""
    tr = ttr.Tracker(random_cfg(), "stereo", device="cpu", enable_loop_closing=False)
    tr.map = random_map(seed)
    tr._n_kf_host = N_KF
    seen = {}
    real = ttr._local_ba

    def try_lock(out):
        got = tr._map_lock.acquire(blocking=False)
        if got:
            tr._map_lock.release()
        out.append(got)

    def solve_then_change(m, *a, **kw):
        free = []
        probe = threading.Thread(target=try_lock, args=(free,))
        probe.start()
        probe.join(10.0)
        seen["free"] = free == [True]
        seen["solved"] = real(m, *a, **kw)
        change(tr)
        seen["live"] = ms.clone_map(tr.map)
        return seen["solved"]

    monkeypatch.setattr(ttr, "_local_ba", solve_then_change)
    cfg = tr.cfg
    with tr._mapper_holding(0):
        tr._local_ba_off_lock((WINDOW, FIXED, tr.cam_params, float(cfg.bf)),
                              dict(cam_model=0, n_ba_points=N_BA, n_iters=3))
    return tr, seen["live"], seen["solved"], seen["free"]


@pytest.mark.parametrize("case", ["unchanged", "keyframe_inserted", "culled_and_reused"])
def test_fold_matches_plain_writeback(case, monkeypatch):
    change = {"unchanged": lambda tr: None,
              "keyframe_inserted": lambda tr: insert_keyframe(tr.map, 11),
              "culled_and_reused": lambda tr: cull_and_reuse(tr.map, 12)}[case]
    tr, live, solved, free = run_off_lock(7, change, monkeypatch)
    assert free, "the solve ran with the map lock held"
    assert tr.stats["local_ba_dropped"] == 0
    want = writeback.writeback(fields(live, writeback.LIVE_FIELDS),
                               fields(solved, writeback.SNAPSHOT_FIELDS), WINDOW, FIXED, N_BA)
    for k, v in want.items():
        assert torch.equal(getattr(tr.map, k), v), k
    # the solve moved the free keyframes, and the fold took what it may
    free_ids = WINDOW[:4].long()
    assert not torch.equal(tr.map.kf_t[free_ids], random_map(7).kf_t[free_ids])
    if case == "unchanged":
        # with nothing in between, the fold leaves what the in-place solve does
        inline = map_ba.map_window_ba(random_map(7), WINDOW, FIXED, tr.cam_params,
                                      float(tr.cfg.bf), cam_model=0, n_ba_points=N_BA,
                                      n_iters=3)
        for k in ms.FIELDS:
            assert torch.equal(getattr(tr.map, k), getattr(inline, k)), k
    else:
        # what was made or culled meanwhile is left as it was
        assert torch.equal(tr.map.kf_t[N_KF], live.kf_t[N_KF])
        gone = ~tr.map.mp_valid | (tr.map.mp_first_kf == N_KF)
        assert gone.any()
        assert torch.equal(tr.map.mp_pos[gone], live.mp_pos[gone])


def test_fold_after_a_compaction_is_dropped_and_counted(monkeypatch):
    compacted = []

    def compact(tr):
        tr.map.mp_valid[:10] = False
        compacted.append(tr._compact_map())

    tr, live, _, free = run_off_lock(8, compact, monkeypatch)
    assert free and compacted == [True]
    assert tr.stats["local_ba_dropped"] == 1 and tr.stats["n_compactions"] == 1
    for k in ms.FIELDS:
        assert torch.equal(getattr(tr.map, k), getattr(live, k)), k


def test_sync_local_ba_solves_the_live_map_in_place():
    """The synchronous tracker's `_run_local_ba` on the small orbit leaves
    the map the code before the mapper's snapshot left: the covisibility
    window, then `map_window_ba` on the live map."""
    imgs, ts, rig = orbit_frames(13)
    tr = ttr.Tracker(backend_config(SlamConfig, rig), "stereo", device="cpu",
                     enable_loop_closing=False)
    cfg = tr.cfg
    real = tr._run_local_ba
    checked = []

    def run_local_ba(kf_id):
        if tr._n_kf_host < 3:
            return real(kf_id)
        m = ms.clone_map(tr.map)
        ids, fixed = lm_ops.covis_ba_window(m, torch.full((), kf_id, dtype=torch.int32),
                                            n_win=cfg.ba.window_size, n_fixed=cfg.ba.n_fixed)
        want = map_ba.map_window_ba(m, ids, fixed, tr.cam_params, float(cfg.bf),
                                    cam_model=cfg.camera.model_id,
                                    n_ba_points=cfg.ba.max_points, n_iters=cfg.ba.n_iters)
        real(kf_id)
        for k in ms.FIELDS:
            assert torch.equal(getattr(tr.map, k), getattr(want, k)), (kf_id, k)
        assert torch.equal(tr.pose[0], want.kf_R[kf_id])
        checked.append(kf_id)

    tr._run_local_ba = run_local_ba
    for img, stamp in zip(imgs, ts):
        tr.process_frame(img, float(stamp))
    assert len(checked) == tr.stats["n_local_ba"] >= 3
    assert tr.stats["local_ba_dropped"] == 0


def test_threads_cell_selects_the_mapper_thread():
    cell = spec.cell("stereo640_threads.orbit")
    assert (cell.config_name, cell.traffic_name, cell.chips) == ("stereo640_threads", "orbit", 1)
    assert set(THREAD_READERS) <= {m.name for m in cell.per_layer}
    # the pinhole cell's deployment, but for its threads
    pinhole = spec.load_json(os.path.join(spec.BENCH_DIR, "configs", "stereo640_pinhole.json"))
    slam = dict(cell.config["slam"])
    assert slam.pop("mapping") == {"mapper_thread": True, "async_gba": True}
    assert slam == pinhole["slam"]
    cfg = runner.slam_config(cell)
    assert cfg.mapping.mapper_thread and cfg.mapping.async_gba
    s = tsys.System(cfg, cell.config["sensor"], device="cpu")
    thread = s.tracker._mapper_thread
    assert thread is not None and thread.is_alive()
    s.shutdown()
    thread.join(10.0)
    assert not thread.is_alive() and s.tracker._mapper_thread is None
    s = tsys.System(runner.slam_config(cell), cell.config["sensor"], background_mapping=False,
                    device="cpu")
    assert s.tracker._mapper_thread is None
    s.shutdown()


def small_cfg(rig):
    """tests/test_torch_tracing.py's configuration (a keyframe every other
    frame) with the mapper thread."""
    cfg = SlamConfig()
    cfg.map.max_kf, cfg.map.max_mp = 64, 4096
    cfg.orb.max_kp, cfg.orb.target_features, cfg.orb.fast_threshold = 384, 300, 12.0
    cfg.tracker.min_init_features = 150
    cfg.tracker.max_frames_between_kf = 2
    cfg.tracker.kf_ref_ratio = 2.0
    cfg.ba.max_points, cfg.ba.window_size = 1024, 6
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    cfg.mapping.mapper_thread = True
    return cfg


def test_threaded_run_records_the_lock_spans():
    """Ten frames at 320x200 on the mapper thread, the interpreter switching
    threads every 0.1 ms: one `track.lock_wait` a frame; per keyframe with a
    local BA two `mapping.locked` intervals or more (the solve between
    them), none overlapping another; no mapper error, nothing dropped."""
    rig = StereoRig(fx=150.0, fy=150.0, cx=160.0, cy=100.0, width=320, height=200)
    frames, rig, _ = render_stereo_sequence(n_frames=10, rig=rig, seed=5)
    s = tsys.System(small_cfg(rig), tsys.SENSOR_STEREO, enable_loop_closing=False,
                    enable_timing=True, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for pair, _, stamp in frames:
            s.track_stereo(pair, stamp)
        s.tracker.wait_mapping_idle(timeout=120.0)
    finally:
        sys.setswitchinterval(old)
    recs = s.tracker.timer.export()
    stats = s.get_stats()
    thread = s.tracker._mapper_thread
    s.tracker.timer.enabled = False
    s.shutdown()
    thread.join(10.0)
    assert not thread.is_alive()
    assert stats["mapper_errors"] == 0 and stats["local_ba_dropped"] == 0
    assert stats["n_local_ba"] >= 2 and stats["mapper_queue_max"] >= 1
    waits = [r for r in recs if r["name"] == "track.lock_wait"]
    assert sorted(r["frame"] for r in waits) == list(range(len(frames)))
    held = sorted((r for r in recs if r["name"] == "mapping.locked"),
                  key=lambda r: r["start_ns"])
    assert all(r["parent"] is None and r["device_s"] is None for r in held)
    for a, b in zip(held, held[1:]):
        assert a["end_ns"] <= b["start_ns"]
    kf_frames = [r["frame"] for r in recs if r["name"] == "keyframe.backend"]
    ba_frames = [r["frame"] for r in recs if r["name"] == "mapping.local_ba"]
    assert {r["frame"] for r in held} == set(kf_frames)
    for f in ba_frames:
        assert sum(r["frame"] == f for r in held) >= 2
    run = RunRecords(frames=[FrameRecord(index=i, ms=1.0, start=0.0, end=0.0, kf=False,
                                         loop=False, fail=False) for i in range(len(frames))],
                     window_s=1.0, stages={"spans": recs})
    for name in ("map_lock_wait_ms", "mapper_locked_ms", "pose_search_host_ms",
                 "mapper_step_host_ms", "local_ba_host_ms"):
        v = spec.load_reader(name)(run)
        assert v is not None and np.isfinite(v) and v >= 0.0, name


@pytest.mark.parametrize("how", ["_reset_active_map", "_spawn_new_map"])
def test_keyframe_steps_stop_when_the_map_is_replaced_during_the_solve(how, monkeypatch):
    """The frame thread resets the map, or archives it for the merger and
    starts a new one (a loss, a timestamp jump), while the mapper's local
    BA of a keyframe that passes the loop probe's gates solves off the
    lock: the solve is dropped and not counted as a local BA, and the
    keyframe's probe, merge detection and inertial back end do not run on
    its id of the old map."""
    rig = StereoRig(fx=150.0, fy=150.0, cx=160.0, cy=100.0, width=320, height=200)
    frames, rig, _ = render_stereo_sequence(n_frames=30, rig=rig, seed=5)
    s = tsys.System(small_cfg(rig), tsys.SENSOR_STEREO, device="cpu")
    tr = s.tracker
    state = {"armed": None, "fired": None, "entry": None, "folds": 0}
    stale = []
    real_solve, real_fold = ttr._local_ba, ttr.fold_window_result
    real_run, real_steps = tr._run_local_ba, tr._mapping_steps

    def mapping_steps(kid, lagged_loops):
        state["entry"] = tr._map_epoch
        return real_steps(kid, lagged_loops)

    def run_local_ba(kf_id):
        if state["fired"] is None and tr.loop_closer.probe_gates_ok(kf_id, tr._n_kf_host):
            state["armed"] = kf_id
        return real_run(kf_id)

    def solve(m, *a, **kw):
        out = real_solve(m, *a, **kw)
        if state["armed"] is not None and state["fired"] is None:
            state["fired"] = state["armed"]
            frame_thread = threading.Thread(target=getattr(tr, how))
            frame_thread.start()
            frame_thread.join(60.0)
        return out

    def fold(*a):
        state["folds"] += 1
        return real_fold(*a)

    def spy(name):
        real = getattr(tr, name)

        def call(*a, **kw):
            if tr._map_epoch != state["entry"]:
                stale.append((name, a[:1]))
            return real(*a, **kw)
        setattr(tr, name, call)

    monkeypatch.setattr(ttr, "_local_ba", solve)
    monkeypatch.setattr(ttr, "fold_window_result", fold)
    tr._mapping_steps, tr._run_local_ba = mapping_steps, run_local_ba
    for name in ("_consume_probes", "_detect_merge", "_inertial_back_end"):
        spy(name)
    for pair, _, stamp in frames:
        if state["fired"] is not None:
            break
        s.track_stereo(pair, stamp)
    tr.wait_mapping_idle(timeout=120.0)
    stats, n_maps = s.get_stats(), len(tr.atlas.maps)
    thread = tr._mapper_thread
    s.shutdown()
    thread.join(10.0)
    assert state["fired"] is not None, "no keyframe passed the probe's gates"
    assert not thread.is_alive() and stats["mapper_errors"] == 0, tr.errors
    assert stats["local_ba_dropped"] == 1
    assert stats["n_local_ba"] == state["folds"] >= 2
    assert stats["n_resets" if how == "_reset_active_map" else "n_new_maps"] == 1
    if how == "_spawn_new_map":
        assert n_maps == 2 and tr.map_merger.archives
    assert stale == []


def _span(i, name, frame, host_s, parent=None):
    return {"id": i, "name": name, "frame": frame, "parent": parent, "start_ns": 0,
            "end_ns": 0, "host_s": host_s, "device_s": host_s / 10, "counts": {}}


def _records(spans, n=6, traced=(5,)):
    frames = [FrameRecord(index=i, ms=40.0, start=0.04 * i, end=0.04 * (i + 1), kf=i % 2 == 0,
                          loop=False, fail=False, traced=i in traced) for i in range(n)]
    stages = {} if spans is None else {"spans": spans}
    return RunRecords(frames=frames, window_s=1.0, stages=stages)


def test_thread_readers_on_hand_made_records():
    recs = [_span(0, "track.lock_wait", 0, 0.004), _span(1, "track.lock_wait", 1, 0.002),
            _span(2, "track.lock_wait", 1, 0.001), _span(3, "track.lock_wait", 5, 0.5),
            _span(4, "mapping.locked", 0, 0.030), _span(5, "mapping.locked", 0, 0.010),
            _span(6, "mapping.locked", 2, 0.020), _span(7, "mapping.locked", 4, 0.050),
            _span(8, "mapping.locked", 5, 0.900),
            _span(9, "loop.gba_thread", 5, 1.5), _span(10, "loop.gba_thread", 2, 0.5),
            _span(11, "track.search", 0, 0.008), _span(12, "track.search", 0, 0.002),
            _span(13, "track.search", 1, 0.006), _span(14, "track.search", 3, 0.020),
            _span(15, "track.search", 5, 0.900),
            _span(16, "mapping.mapper_step", 0, 0.030), _span(17, "mapping.mapper_step", 2, 0.050),
            _span(18, "mapping.mapper_step", 4, 0.040), _span(19, "mapping.mapper_step", 5, 0.9),
            _span(20, "mapping.local_ba", 0, 0.300), _span(21, "mapping.local_ba", 4, 0.100),
            _span(22, "mapping.local_ba", 5, 0.9),
            {**_span(23, "loop.probe", 2, 2.0), "counts": {"closed": 1}},
            _span(24, "loop.verify", 2, 0.3, parent=23), _span(25, "loop.correct", 2, 0.9,
                                                              parent=23),
            _span(26, "loop.probe", 4, 0.1), _span(27, "loop.verify", 4, 0.05, parent=26),
            {**_span(28, "loop.probe", 5, 9.0), "counts": {"closed": 1}},
            _span(29, "loop.verify", 5, 9.0, parent=28)]
    run = _records(recs)
    read = {name: spec.load_reader(name) for name in THREAD_READERS}
    # frames 0-4 outside the slice: waits 4, 3, 0, 0, 0 ms, host time
    assert read["map_lock_wait_ms"](run) == pytest.approx(7.0 / 5)
    # keyframes 0, 2, 4 outside the slice: 40, 20 and 50 ms held
    assert read["mapper_locked_ms"](run) == pytest.approx(40.0)
    # every closed global BA of the window, slice or not
    assert read["gba_thread_ms"](run) == pytest.approx(1000.0)
    # host time, not the device events' tenth: frames 0, 1, 3 searched 10, 6, 20 ms
    assert read["pose_search_host_ms"](run) == pytest.approx(10.0)
    assert read["mapper_step_host_ms"](run) == pytest.approx(40.0)
    assert read["local_ba_host_ms"](run) == pytest.approx(200.0)
    # the one closed probe outside the slice: its verify and correct
    assert read["loop_close_host_ms"](run) == pytest.approx(1200.0)


@pytest.mark.parametrize("spans", [None, []])
def test_thread_readers_return_nothing_without_their_spans(spans):
    run = _records(spans)
    for name in THREAD_READERS:
        assert spec.load_reader(name)(run) is None, name
