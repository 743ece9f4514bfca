"""The port's threads: the background mapper (`Tracker(async_mapping=True)`),
the asynchronous global BA (`cfg.mapping.async_gba`) and its merge
(`map_ba.merge_gba_result`), on the CPU.

Threaded runs are not deterministic (which keyframes the busy-mapper gate
lets through depends on timing), so they are held the way the reference's
own tests hold them (tests/test_async_mapping.py, tests/test_inertial_loops.py):
the ATE bound (< 0.06 m) and within 5 mm of the port's synchronous run on
the same frames; an injected error survived and counted; the threads
joined. The merge is deterministic and is held to the reference's
`merge_gba_result` to 1e-5 on captured maps; `dispatch_probe` to the
reference's pack (ids equal, scores to 1e-6).

Named exceptions, for two faults of the reference confirmed here on the
reference itself:
- fault 1: its pipelined keyframe (`_create_keyframe_from_record`,
  tracker.py:1259-1261) sets `abort_gba` whatever the GBA mode, so a
  dedicated GBA thread running when the keyframe lands is aborted and never
  merges. The port aborts that thread only on a newer loop, a compaction or
  a reset: the same keyframe leaves its GBA running, and it merges.
- fault 2: its `merge_gba_result` takes the slots below the launch-time
  landmark count (map_ba.py:252, `pp < n_mp0`). A landmark spawned during
  the GBA into a recycled slot below it gets the dead occupant's GBA
  position, and one the GBA optimised at a slot at or above it (the ring
  world's duplicate landmarks, ids from 500, with a live count near 420)
  is re-anchored through its keyframe instead of taking its optimised
  position. The port takes the launch-time occupants by
  the snapshot's `mp_valid` and `mp_first_kf`; outside these slots both
  merges agree to 1e-5.
"""
import queue
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.mapping import loop_closing as jlc, map_ba as jmb  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms, vocabulary as jvb  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu.tracking.reloc import PlaceRecognition as JPR  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.evaluation import ate_rmse  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import render_stereo_sequence  # noqa: E402
from orbslam3lib_tpu_torch.mapping import loop_closing as tlc, map_ba as tmb  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms, vocabulary as tvb  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402
from orbslam3lib_tpu_torch.tracking.reloc import PlaceRecognition as TPR  # noqa: E402
from orbslam3lib_tpu_torch.utils import lie as tlie  # noqa: E402

from torch_parity import (RING_CAM as CAM, reference_ransac_draws,  # noqa: E402
                          reference_single_device_gba, ring_world)

LAST = 12          # the ring world's revisiting keyframe
F = 160


def base_config(cfg_cls, rig):
    """tests/test_async_mapping.py's configuration."""
    cfg = cfg_cls()
    cfg.map.max_kf = 64
    cfg.map.max_mp = 4096
    cfg.orb.max_kp = 384
    cfg.orb.target_features = 300
    cfg.orb.fast_threshold = 12.0
    cfg.tracker.min_init_features = 150
    cfg.ba.max_points = 1024
    cfg.ba.window_size = 6
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    return cfg


def ring_config(cfg_cls):
    cfg = cfg_cls()
    cfg.map.max_kf = 32
    cfg.map.max_mp = 1024
    cfg.orb.max_kp = F
    cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy = (float(x) for x in CAM)
    cfg.camera.width, cfg.camera.height = 640, 400
    cfg.mapping.async_gba = True
    return cfg


@pytest.fixture(scope="module")
def sequence():
    return render_stereo_sequence(30, dt=1.0 / 15.0, seed=5)


@pytest.fixture(scope="module")
def ring():
    return ring_world()


def _ate(tr, frames):
    est = tr.trajectory_centers()
    gt = np.stack([-R.T @ t for _, (R, t), _ in frames[-len(est):]])
    return ate_rmse(est, gt)


def test_mapper_thread_matches_sync_quality(sequence):
    """The mapper thread (with the interpreter switching threads every
    0.1 ms to shuffle their interleaving): ATE < 0.06 m and within 5 mm of
    the synchronous tracker's; every keyframe after the first mapped once;
    `shutdown_mapping` joins the thread."""
    frames, rig, _ = sequence
    sync = ttr.Tracker(base_config(TCfg, rig), "stereo", device="cpu",
                       enable_loop_closing=False)
    for img, _, stamp in frames:
        sync.process_frame(img, stamp)
    tr = ttr.Tracker(base_config(TCfg, rig), "stereo", device="cpu",
                     enable_loop_closing=False, async_mapping=True)
    thread = tr._mapper_thread
    assert thread is not None and thread.is_alive()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for img, _, stamp in frames:
            tr.process_frame(img, stamp)
        tr.wait_mapping_idle(timeout=120.0)
    finally:
        sys.setswitchinterval(old)
    assert tr.state == ttr.OK and tr.stats["n_kf"] >= 2
    assert tr.stats["mapper_errors"] == 0 and not tr.errors
    assert tr.stats["n_mapping_steps"] == tr.stats["n_kf"] - 1
    ate, ate_sync = _ate(tr, frames), _ate(sync, frames)
    assert ate < 0.06 and abs(ate - ate_sync) < 0.005, (ate, ate_sync)
    tr.shutdown_mapping()
    assert tr._mapper_thread is None and not thread.is_alive()


def test_mapper_survives_an_error(sequence):
    """An exception in one keyframe's mapping: the thread counts it in
    `stats["mapper_errors"]`, keeps its traceback, and maps the next
    keyframes."""
    frames, rig, _ = sequence
    cfg = base_config(TCfg, rig)
    cfg.tracker.min_frames_between_kf = 2     # a keyframe every 2 frames
    cfg.tracker.kf_ref_ratio = 10.0
    tr = ttr.Tracker(cfg, "stereo", device="cpu", enable_loop_closing=False,
                     async_mapping=True)
    real = tr._mapping_pipeline
    calls = []

    def flaky(kid, **kw):
        calls.append(kid)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(kid, **kw)

    tr._mapping_pipeline = flaky
    for img, _, stamp in frames[:12]:
        tr.process_frame(img, stamp)
    tr.wait_mapping_idle(timeout=120.0)
    assert tr.stats["mapper_errors"] == 1 and "injected" in tr.errors[0]
    assert len(calls) >= 3 and tr.stats["n_mapping_steps"] == len(calls) - 1
    assert tr._mapper_thread.is_alive() and tr.state == ttr.OK
    thread = tr._mapper_thread
    tr.shutdown_mapping()
    assert not thread.is_alive()


# -- merge_gba_result --------------------------------------------------------

def _gba_like(arrays):
    """A known 'GBA result': every snapshot pose and landmark moved by one
    world transform (tests/test_inertial_loops.py), and each landmark by a
    seeded offset of its own (up to 2 cm), which re-anchoring through a
    keyframe cannot reproduce."""
    dR, dt = tlie.se3_exp(torch.tensor([0.3, -0.2, 0.1, 0.0, 0.05, 0.0]))
    dR, dt = dR.numpy(), dt.numpy()
    gba_R = np.einsum("kij,jl->kil", arrays["kf_R"], dR.T).astype(np.float32)
    gba_t = (arrays["kf_t"] - np.einsum("kij,j->ki", gba_R, dt)).astype(np.float32)
    jitter = np.random.default_rng(3).uniform(-0.02, 0.02, arrays["mp_pos"].shape)
    gba_pos = (arrays["mp_pos"] @ dR.T + dt + jitter).astype(np.float32)
    return gba_R, gba_t, gba_pos


def _reanchored(arrays, gba, ids):
    """Landmarks `ids` carried by their first keyframe's move from its
    snapshot pose to its GBA pose."""
    k = arrays["mp_first_kf"][ids]
    R_b, t_b = arrays["kf_R"][k], arrays["kf_t"][k]
    R_a, t_a = gba[0][k], gba[1][k]
    p_cam = np.einsum("pij,pj->pi", R_b, arrays["mp_pos"][ids]) + t_b
    return np.einsum("pji,pj->pi", R_a, p_cam - t_a)


def _add_keyframes(arrays, n=2):
    """Two keyframes made while the GBA runs, children of the last one,
    inserted by each package's `insert_keyframe`."""
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tm = tms.from_numpy(arrays)
    k0 = int(arrays["n_kf"]) - 1
    for j in range(n):
        R = arrays["kf_R"][k0]
        t = arrays["kf_t"][k0] + np.float32(0.1 * (j + 1))
        args = (arrays["kf_xy"][k0], np.zeros(F, np.int32), arrays["kf_desc"][k0],
                arrays["kf_feat_valid"][k0], arrays["kf_mp"][k0], np.zeros(F, np.float32))
        jm, jk = jms.insert_keyframe(jm, jnp.asarray(R), jnp.asarray(t), jnp.float32(99 + j),
                                     *(jnp.asarray(a) for a in args))
        tm, tk = tms.insert_keyframe(tm, torch.from_numpy(R), torch.from_numpy(t), 99.0 + j,
                                     *(torch.from_numpy(np.array(a)) for a in args))
        assert int(jk) == tk == k0 + 1 + j
    return jm, tm


def _merge_both(jm, tm, snap, gba, n_kf0):
    gba_R, gba_t, gba_pos = gba
    want = jmb.merge_gba_result(jm, jnp.asarray(gba_R), jnp.asarray(gba_t),
                                jnp.asarray(gba_pos), jnp.int32(n_kf0),
                                jnp.int32(int(snap["n_mp"])))
    got = tmb.merge_gba_result(tm, torch.from_numpy(gba_R), torch.from_numpy(gba_t),
                               torch.from_numpy(gba_pos), n_kf0, int(tm.n_kf),
                               torch.from_numpy(snap["mp_valid"]),
                               torch.from_numpy(snap["mp_first_kf"]))
    return ({k: np.asarray(getattr(want, k)) for k in ("kf_R", "kf_t", "mp_pos")},
            {k: getattr(got, k).numpy() for k in ("kf_R", "kf_t", "mp_pos")})


def test_merge_propagates_new_keyframes_through_tree(ring):
    """tests/test_inertial_loops.py's case on the ring world, its snapshot's
    landmark count raised above every occupied slot (the reference's test
    writes n_mp = 700): both merges equal to 1e-5; snapshot keyframes and
    landmarks take the GBA's values, the two new keyframes keep their pose
    relative to their parent."""
    arrays = dict(ring[0])
    arrays["n_mp"] = np.int32(700)
    n_kf0 = int(arrays["n_kf"])
    gba = _gba_like(arrays)
    jm, tm = _add_keyframes(arrays)
    want, got = _merge_both(jm, tm, arrays, gba, n_kf0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["kf_R"][:n_kf0], gba[0][:n_kf0], rtol=0, atol=1e-6)
    live = arrays["mp_valid"]
    np.testing.assert_allclose(got["mp_pos"][live], gba[2][live], rtol=0, atol=1e-6)
    for kid in (n_kf0, n_kf0 + 1):
        par = int(tm.kf_parent[kid])
        assert 0 <= par < n_kf0

        def rel(R, t):
            Rpi, tpi = tlie.se3_inverse(torch.from_numpy(R[par]), torch.from_numpy(t[par]))
            return tlie.se3_compose(torch.from_numpy(R[kid]), torch.from_numpy(t[kid]),
                                    Rpi, tpi)
        before = rel(tm.kf_R.numpy(), tm.kf_t.numpy())
        after = rel(got["kf_R"], got["kf_t"])
        for a, b in zip(after, before):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


def test_merge_recycled_slot(ring):
    """Fault 2 (named exception): the snapshot's live count is the ring
    world's ~420 live landmarks, with its duplicates at ids from 500; after
    the snapshot, landmark 7 is culled and a new one, first seen by the
    first keyframe made during the GBA, is spawned into its slot. The
    reference gives the newcomer the dead occupant's GBA position and
    re-anchors the duplicates through their keyframe (losing their own GBA
    positions); the port re-anchors the newcomer
    through its keyframe and moves the duplicates with the GBA. Every other
    slot, and every pose, agrees to 1e-5."""
    snap = dict(ring[0])
    n_mp0, n_kf0 = int(snap["n_mp"]), int(snap["n_kf"])
    gba = _gba_like(snap)
    arrays = {k: np.array(v) for k, v in snap.items()}
    arrays["mp_valid"][7] = False                      # culled during the GBA
    jm, tm = _add_keyframes(arrays)
    slot, kid = 7, n_kf0
    p_new = np.array([0.5, 0.2, 4.0], np.float32)
    for m in (tm,):
        m.mp_valid[slot], m.mp_first_kf[slot] = True, kid
        m.mp_pos[slot] = torch.from_numpy(p_new)
    jm = jm._replace(mp_valid=jm.mp_valid.at[slot].set(True),
                     mp_first_kf=jm.mp_first_kf.at[slot].set(kid),
                     mp_pos=jm.mp_pos.at[slot].set(p_new))
    R_b, t_b = tm.kf_R[kid].numpy().copy(), tm.kf_t[kid].numpy().copy()
    want, got = _merge_both(jm, tm, snap, gba, n_kf0)
    dup = np.flatnonzero(snap["mp_valid"] & (np.arange(len(snap["mp_valid"])) >= n_mp0))
    assert len(dup) > 40 and slot < n_mp0
    # the reference's merge, confirmed on the reference: the newcomer at the
    # dead occupant's GBA position, the duplicates re-anchored (not their
    # own GBA positions)
    np.testing.assert_allclose(want["mp_pos"][slot], gba[2][slot], rtol=0, atol=1e-6)
    np.testing.assert_allclose(want["mp_pos"][dup], _reanchored(snap, gba, dup),
                               rtol=0, atol=1e-5)
    assert np.abs(want["mp_pos"][dup] - gba[2][dup]).max() > 5e-3
    # the port's: the newcomer re-anchored through keyframe `kid`'s (before,
    # after) poses, the duplicates at their GBA positions
    R_a, t_a = got["kf_R"][kid], got["kf_t"][kid]
    np.testing.assert_allclose(got["mp_pos"][slot], R_a.T @ (R_b @ p_new + t_b - t_a),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["mp_pos"][dup], gba[2][dup], rtol=0, atol=1e-6)
    other = np.ones(len(snap["mp_valid"]), bool)
    other[dup] = other[slot] = False
    np.testing.assert_allclose(got["mp_pos"][other], want["mp_pos"][other], rtol=0, atol=1e-5)
    for k in ("kf_R", "kf_t"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


# -- the GBA thread -----------------------------------------------------------

def _vocabularies(descs):
    jv = jvb.train_vocabulary(descs, k=4, depth=3)
    tv = tvb.Vocabulary(centroids=tuple(torch.from_numpy(np.array(c)) for c in jv.centroids),
                        idf=torch.from_numpy(np.array(jv.idf)), k=jv.k, depth=jv.depth)
    return jv, tv


def _ring_tracker(ring, **kw):
    """A port tracker whose map is the ring world, with a loop closer whose
    database holds its keyframes (one coincidence confirms a loop)."""
    arrays, _, descs = ring
    _, tv = _vocabularies(descs)
    tr = ttr.Tracker(ring_config(TCfg), "stereo", device="cpu",
                     enable_loop_closing=False, **kw)
    tr.map = tms.from_numpy(arrays)
    tr._n_kf_host = int(arrays["n_kf"])
    tr.state = ttr.OK
    pr = TPR(tv, max_kf=32)
    for i in range(LAST + 1):
        pr.add(i, tr.map.kf_desc[i], tr.map.kf_feat_valid[i])
    tr.place_rec = pr
    return tr


def _pose_err(m, true):
    R, t = m.kf_R.numpy(), m.kf_t.numpy()
    return np.array([np.linalg.norm(-R[i].T @ t[i] + true[i][0].T @ true[i][1])
                     for i in range(LAST + 1)])


def test_dispatch_probe(ring):
    """`LoopCloser.dispatch_probe` against the reference's: the revisit's
    candidates (ids equal, scores and covisibility to 1e-6), padded to 16;
    None for a keyframe the gates reject."""
    arrays, _, descs = ring
    jv, tv = _vocabularies(descs)
    jpr, tpr = JPR(jv, max_kf=32), TPR(tv, max_kf=32)
    for i in range(LAST + 1):
        jpr.add(i, jnp.asarray(arrays["kf_desc"][i]), jnp.asarray(arrays["kf_feat_valid"][i]))
        tpr.add(i, torch.from_numpy(arrays["kf_desc"][i]),
                torch.from_numpy(arrays["kf_feat_valid"][i]))
    jcl, tcl = jlc.LoopCloser(JCfg(), jpr), tlc.LoopCloser(TCfg(), tpr)
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = np.asarray(jcl.dispatch_probe(jm, LAST, LAST + 1))
    got = tcl.dispatch_probe(tms.from_numpy(arrays), LAST, LAST + 1).numpy()
    assert got.shape == want.shape == (16,) and int(got[0]) == 0
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_allclose(got[3:], want[3:], rtol=0, atol=1e-6)
    assert tcl.dispatch_probe(tms.from_numpy(arrays), LAST, 7) is None


def test_async_gba_thread_runs_and_merges(ring):
    """tests/test_inertial_loops.py::test_async_gba_thread_runs_and_merges,
    visual: a loop correction on the ring world starts the GBA on its own
    thread; a keyframe is inserted while it runs; the GBA merges, the new
    keyframe survives, the drift is no worse, `n_gba_merged` counts it."""
    tr = _ring_tracker(ring)
    arrays, true, _ = ring
    lc = tlc.LoopCloser(tr.cfg, tr.place_rec, consistency_needed=1, gba_iters=4,
                        fix_scale=True)
    assert lc.async_gba
    tr.loop_closer = lc
    probe = lc.dispatch_probe(tr.map, LAST, LAST + 1).numpy()
    with reference_ransac_draws(), tr._map_lock:
        tr._consume_probes([(LAST, probe)])
    assert lc.n_loops == 1 and tr.stats["n_gba_started"] == 1
    assert tr._gba_thread is not None
    err_pre = _pose_err(tr.map, true).mean()
    with tr._map_lock:
        k = LAST
        tms.insert_keyframe(tr.map, tr.map.kf_R[k].clone(), tr.map.kf_t[k].clone(), 99.0,
                            tr.map.kf_xy[k].clone(), torch.zeros(F, dtype=torch.int32),
                            tr.map.kf_desc[k].clone(), tr.map.kf_feat_valid[k].clone(),
                            tr.map.kf_mp[k].clone(), torch.zeros(F))
        tr._n_kf_host += 1
    tr.wait_gba(timeout=120.0)
    assert tr._gba_thread is None
    assert tr.stats["n_gba_merged"] == 1 and tr.stats["gba_errors"] == 0
    assert int(tr.map.n_kf) == LAST + 2
    assert _pose_err(tr.map, true).mean() <= err_pre * 1.2 + 1e-3


def test_abort_discards_inflight_gba(ring):
    """An abort (a newer loop, a compaction or a reset) joins the running
    GBA and leaves the live map as it was."""
    tr = _ring_tracker(ring)
    tr.loop_closer = tlc.LoopCloser(tr.cfg, tr.place_rec, gba_iters=200)
    before = tr.map.kf_t.clone()
    with tr._map_lock:
        tr._maybe_start_gba()
    thread = tr._gba_thread
    time.sleep(0.05)
    tr._abort_gba_and_join()
    assert tr._gba_thread is None and not thread.is_alive()
    assert tr.stats["n_gba_aborted"] == 1 and tr.stats["n_gba_merged"] == 0
    assert torch.equal(before, tr.map.kf_t)


def _record_frame(arrays):
    """Keyframe LAST's features as one consumed frame of a chunk."""
    k = LAST
    return dict(xy=arrays["kf_xy"][k], level=np.zeros(F, np.int32),
                angle=arrays["kf_angle"][k], desc=arrays["kf_desc"][k],
                valid=arrays["kf_feat_valid"][k], u_r=np.full(F, -1.0, np.float32),
                depth=np.zeros(F, np.float32),
                mp_feat=np.full(len(arrays["mp_valid"]), -1, np.int32),
                R=arrays["kf_R"][k], t=arrays["kf_t"][k])


def test_pipelined_keyframe_leaves_the_gba_running(ring):
    """Fault 1 (named exception), on both packages: a pipelined tracker with
    the mapper queue and `async_gba`; a GBA thread runs on the ring world
    when a pipelined keyframe lands (`_create_keyframe_from_record`). The
    reference sets `abort_gba`, its GBA stops and never merges (the
    snapshot keyframes keep their poses); the port's GBA keeps running and
    merges (they move)."""
    arrays, _, _ = ring
    n_kf = int(arrays["n_kf"])
    fr = _record_frame(arrays)

    # the reference
    jt = jtr.Tracker(ring_config(JCfg), "stereo", enable_loop_closing=False, pipeline=6,
                     chunk=2, async_mapping=True)
    jt._mapper_stop = True                    # keep the queued id unmapped
    jt._mapper_thread.join(timeout=10.0)
    jt._map_queue = queue.Queue()
    jt.map = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jt._n_kf_host = n_kf
    jt.state = jtr.OK
    jt.loop_closer = jlc.LoopCloser(jt.cfg, None, gba_iters=20)
    jt.loop_closer.async_gba = True
    rec = ([99.0], [0], 1, None) + tuple(
        jnp.asarray(fr[k])[None] for k in ("xy", "level", "angle", "desc", "valid", "u_r",
                                           "depth", "mp_feat")) + ([], None)
    # the lock is held from the GBA's start until the keyframe is in, so the
    # GBA cannot merge before the keyframe lands, whatever its speed
    with reference_single_device_gba():
        with jt._map_lock:
            jt._maybe_start_gba()
            assert jt._gba_thread.is_alive()
            jt._create_keyframe_from_record(rec, 0, fr["R"], fr["t"], 100)
        assert jt.loop_closer.abort_gba is True
        jt.wait_gba(timeout=120.0)
    assert jt._gba_thread is None and int(jt._nkf) == n_kf + 1
    np.testing.assert_array_equal(np.asarray(jt.map.kf_t)[:n_kf], arrays["kf_t"][:n_kf])

    # the port
    tt = ttr.Tracker(ring_config(TCfg), "stereo", device="cpu", enable_loop_closing=False,
                     pipeline=6, chunk=2, async_mapping=True)
    tt._mapper_stop = True
    tt._mapper_thread.join(timeout=10.0)
    tt._map_queue = queue.Queue()
    tt.map = tms.from_numpy(arrays)
    tt._n_kf_host = n_kf
    tt.state = ttr.OK
    tt.loop_closer = tlc.LoopCloser(tt.cfg, None, gba_iters=20)
    assert tt.loop_closer.async_gba
    outs = (None,) + tuple(torch.from_numpy(np.array(fr[k])) for k in
                           ("xy", "level", "angle", "desc", "valid", "u_r", "depth", "mp_feat"))
    rec_t = ttr._Chunk([99.0], [0], [outs], [], None, None)
    with tt._map_lock:
        tt._maybe_start_gba()
        tt._create_keyframe_from_record(rec_t, 0, fr["R"], fr["t"], 100)
    assert tt._gba_thread is not None and not tt._gba_abort.is_set()
    assert tt._map_queue.qsize() == 1
    tt.wait_gba(timeout=120.0)
    assert tt.stats["n_gba_merged"] == 1 and tt.stats["n_gba_aborted"] == 0
    assert int(tt.map.n_kf) == n_kf + 1
    assert np.abs(tt.map.kf_t.numpy()[:n_kf] - arrays["kf_t"][:n_kf]).max() > 1e-4
