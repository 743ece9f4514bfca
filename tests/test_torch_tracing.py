"""The port's span recorder (`utils.timing.StageTimer`). Off, `span` and
`stage` hand back one shared no-op and record nothing. On, over a short
stereo `System` run with keyframes and local BA: every span lies inside its
parent on the host clock, a parent's children take no longer than it, the
stage samples keep one entry per frame, and the tracking and back-end spans
carry the ids of the frames they serve; an inertial run records the frame's
inertial solve and the VI window; under a CPU `torch.profiler` each span is
an `orbslam.*` annotation inside its frame's. Also: threads keep stacks of
their own, and an interval stands outside its thread's stack. The runs are tests/test_torch_system.py's small configuration
at 320x200, with a keyframe every other frame."""
import sys
import threading
from collections import defaultdict

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu_torch import system as tsys  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import (StereoRig, corridor_imu_stream,  # noqa: E402
                                                render_stereo_sequence)
from orbslam3lib_tpu_torch.utils.timing import NO_SPAN, SPANS, StageTimer  # noqa: E402

RIG = StereoRig(fx=150.0, fy=150.0, cx=160.0, cy=100.0, width=320, height=200)
STEREO_FRAMES = 6
PROFILED = (4, 5)           # frame 4 makes the third keyframe: local BA
IMU_FRAMES = 15             # the IMU initialises at frame 12 (10 Hz)


def small_cfg(rig):
    """tests/test_torch_system.py's configuration, a keyframe every other
    frame."""
    cfg = SlamConfig()
    cfg.map.max_kf = 64
    cfg.map.max_mp = 4096
    cfg.orb.max_kp = 384
    cfg.orb.target_features = 300
    cfg.orb.fast_threshold = 12.0
    cfg.tracker.min_init_features = 150
    cfg.tracker.max_frames_between_kf = 2
    cfg.tracker.kf_ref_ratio = 2.0
    cfg.ba.max_points = 1024
    cfg.ba.window_size = 6
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    return cfg


@pytest.fixture(scope="module")
def stereo_run():
    """Six frames with timing on, the last two under a CPU profiler: the
    system's results, its timer's records and samples, and the profiler's
    annotations (name, start, end in ns)."""
    frames, rig, _ = render_stereo_sequence(n_frames=STEREO_FRAMES, rig=RIG, seed=5)
    s = tsys.System(small_cfg(rig), tsys.SENSOR_STEREO, enable_loop_closing=False,
                    enable_timing=True, device="cpu")
    outs = []
    prof = None
    for i, (pair, _, stamp) in enumerate(frames):
        if i == PROFILED[0]:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
            prof.start()
        outs.append(s.track_stereo(pair, stamp))
    prof.stop()
    ann = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("orbslam.")]
    timer = s.tracker.timer
    recs = timer.export()
    samples = {k: list(v) for k, v in timer.samples.items() if k != SPANS}
    stats = s.get_stats()
    timer.enabled = False
    s.shutdown()
    return {"outs": outs, "recs": recs, "samples": samples, "stats": stats, "ann": ann}


@pytest.fixture(scope="module")
def imu_run():
    """Fifteen frames at 10 Hz on `imu_stereo` with timing on; the IMU
    initialises, then a frame solves against it and a keyframe runs the VI
    window."""
    frames, rig, _ = render_stereo_sequence(n_frames=IMU_FRAMES, rig=RIG, dt=0.1, seed=5)
    ci = SlamConfig().imu
    imu = corridor_imu_stream(np.array([f[2] for f in frames]), ci.noise_gyro, ci.noise_acc,
                              ci.freq, (0.002, -0.001, 0.0015), (0.02, -0.01, 0.015), seed=0)
    s = tsys.System(small_cfg(rig), tsys.SENSOR_IMU_STEREO, enable_loop_closing=False,
                    enable_timing=True, device="cpu")
    ready = []
    for (pair, _, stamp), samples in zip(frames, imu):
        s.track_stereo(pair, stamp, imu=samples)
        ready.append(s.tracker.imu_ready)
    recs = s.tracker.timer.export()
    s.tracker.timer.enabled = False
    s.shutdown()
    return {"recs": recs, "ready": ready}


def _by_id(recs):
    return {r["id"]: r for r in recs}


def _root(recs, r):
    by_id = _by_id(recs)
    while r["parent"] is not None:
        r = by_id[r["parent"]]
    return r


def test_off_hands_back_the_shared_noop_and_records_nothing():
    t = StageTimer(enabled=False)
    assert t.span("track.search") is NO_SPAN
    assert t.span("frame", frame=3, n=1) is NO_SPAN
    assert t.stage("extract") is NO_SPAN
    with t.span("mapping.local_ba") as sp, t.stage("track"):
        sp.set(closed=1)
    assert dict(t.samples) == {} and t.export() == []
    tr = tsys.System(small_cfg(RIG), tsys.SENSOR_STEREO, enable_loop_closing=False,
                     device="cpu").tracker
    assert tr.timer.span("frame", frame=0) is NO_SPAN


def test_spans_nest_inside_their_parents(stereo_run):
    recs = stereo_run["recs"]
    by_id = _by_id(recs)
    assert [r["name"] for r in recs if r["parent"] is None] == ["frame"] * STEREO_FRAMES
    assert [r["frame"] for r in recs if r["parent"] is None] == list(range(STEREO_FRAMES))
    for r in recs:
        assert r["device_s"] is None and r["host_s"] == (r["end_ns"] - r["start_ns"]) * 1e-9
        if r["parent"] is None:
            continue
        p = by_id[r["parent"]]
        assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"], (p, r)
        assert r["frame"] == p["frame"]


def test_children_take_no_longer_than_their_parent(stereo_run):
    kids = defaultdict(float)
    for r in stereo_run["recs"]:
        if r["parent"] is not None:
            kids[r["parent"]] += r["end_ns"] - r["start_ns"]
    by_id = _by_id(stereo_run["recs"])
    assert kids
    for pid, total in kids.items():
        p = by_id[pid]
        assert total <= p["end_ns"] - p["start_ns"], p


def test_stage_samples_keep_one_entry_per_frame(stereo_run):
    samples, recs = stereo_run["samples"], stereo_run["recs"]
    assert len(samples["extract"]) == len(samples["stereo_match"]) == STEREO_FRAMES
    # the first frame initialises the map and runs no `track` stage
    assert len(samples["track"]) == STEREO_FRAMES - 1
    for stage in ("extract", "stereo_match", "track"):
        assert samples[stage] == [r["host_s"] for r in recs if r["name"] == stage]
        assert all(_root(recs, r)["name"] == "frame" for r in recs if r["name"] == stage)


def test_search_and_local_ba_carry_their_frame_ids(stereo_run):
    recs, outs, stats = stereo_run["recs"], stereo_run["outs"], stereo_run["stats"]
    search = [r for r in recs if r["name"] == "track.search"]
    assert [r["frame"] for r in search] == list(range(1, STEREO_FRAMES))
    by_id = _by_id(recs)
    assert all(by_id[r["parent"]]["name"] == "track" for r in search)
    ba = [r for r in recs if r["name"] == "mapping.local_ba"]
    assert len(ba) == stats["n_local_ba"] >= 1
    kf_frames = {i for i, o in enumerate(outs) if o.get("kf")}
    assert {r["frame"] for r in ba} <= kf_frames and 4 in {r["frame"] for r in ba}
    for r in ba:
        assert by_id[r["parent"]]["name"] == "keyframe.backend"
        assert _root(recs, r)["frame"] == r["frame"]
    steps = [r for r in recs if r["name"] == "mapping.mapper_step"]
    assert len(steps) == stats["n_mapping_steps"]
    assert sorted(r["frame"] for r in steps) == sorted(kf_frames)


def test_search_spans_count_the_pose_evaluations(stereo_run):
    """Each search runs two pose solves of rounds x (iterations + 1)
    evaluations, on the CPU all by the torch ops; the stats count every
    solve of the frames, these and any fallback's or relocalisation's."""
    recs, stats = stereo_run["recs"], stereo_run["stats"]
    tc = small_cfg(RIG).tracker
    per_search = 2 * tc.pose_rounds * (tc.pose_iters + 1)
    search = [r for r in recs if r["name"] == "track.search"]
    assert search
    for r in search:
        assert r["counts"] == {"pose_evals_fused": 0, "pose_evals_torch": per_search}
    assert stats["pose_evals_fused"] == 0
    assert stats["ref_kf_fallbacks"] == stats["track_fail"] == 0
    assert stats["pose_evals_torch"] == per_search * len(search)


def test_inertial_run_records_the_solve_and_the_window(imu_run):
    recs, ready = imu_run["recs"], imu_run["ready"]
    assert ready[-1] and not ready[0]
    first = ready.index(True)
    solves = [r for r in recs if r["name"] == "track.inertial_solve"]
    assert solves and all(r["frame"] > first for r in solves)
    by_id = _by_id(recs)
    assert all(by_id[r["parent"]]["name"] == "track" for r in solves)
    windows = [r for r in recs if r["name"] == "mapping.vi_window"]
    # the keyframe that initialises the IMU runs the first window
    assert windows and all(r["frame"] >= first for r in windows)
    assert all(by_id[r["parent"]]["name"] == "keyframe.backend" for r in windows)
    pre = [r for r in recs if r["name"] == "imu.preintegrate"]
    assert [r["frame"] for r in pre] == list(range(1, IMU_FRAMES))
    assert all(r["parent"] is None for r in pre)


def test_profiler_sees_each_span_inside_its_frame(stereo_run):
    ann = stereo_run["ann"]
    frames = [(a, b) for name, a, b in ann if name == "orbslam.frame"]
    assert len(frames) == len(PROFILED)
    names = {name for name, _, _ in ann}
    assert {"orbslam.extract", "orbslam.stereo_match", "orbslam.track",
            "orbslam.track.search", "orbslam.keyframe.insert", "orbslam.mapping.mapper_step",
            "orbslam.mapping.local_ba"} <= names
    for name, a, b in ann:
        assert any(f0 <= a <= b <= f1 for f0, f1 in frames), name
    want = sum(1 for r in stereo_run["recs"] if r["frame"] in PROFILED)
    assert len(ann) == want


def test_threads_keep_stacks_of_their_own():
    """Sixteen threads open nested spans at once, the interpreter switching
    threads every microsecond: every inner span's parent is its own
    thread's outer span."""
    t = StageTimer(enabled=True)
    n_threads, n_iter = 16, 100
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for j in range(n_iter):
                with t.span("outer", frame=k), t.span("inner") as sp:
                    sp.set(j=j)
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    recs = t.export()
    by_id = _by_id(recs)
    assert len(recs) == 2 * n_threads * n_iter
    inner = [r for r in recs if r["name"] == "inner"]
    assert len(inner) == n_threads * n_iter
    for r in inner:
        p = by_id[r["parent"]]
        assert p["name"] == "outer" and p["frame"] == r["frame"]
    per_thread = defaultdict(list)
    for r in inner:
        per_thread[r["frame"]].append(r["counts"]["j"])
    assert all(v == list(range(n_iter)) for v in per_thread.values())


def test_intervals_stand_outside_the_stack():
    """An interval opened inside one span and closed inside the next,
    after its opener closed: no parent, parent of nothing, its frame the
    opener's, host time only; the spans around it nest as before."""
    t = StageTimer(enabled=True)
    with t.span("a", frame=7):
        held = t.interval("held")
        held.__enter__()
        with t.span("a.child"):
            pass
    with t.span("b", frame=8):
        held.__exit__(None, None, None)
        with t.span("b.child"):
            pass
    recs = {r["name"]: r for r in t.export()}
    by_id = _by_id(list(recs.values()))
    iv = recs["held"]
    assert iv["parent"] is None and iv["frame"] == 7 and iv["device_s"] is None
    assert recs["a"]["start_ns"] <= iv["start_ns"] <= recs["a"]["end_ns"]
    assert recs["b"]["start_ns"] <= iv["end_ns"] <= recs["b"]["end_ns"]
    assert by_id[recs["a.child"]["parent"]]["name"] == "a"
    assert by_id[recs["b.child"]["parent"]]["name"] == "b"
    assert t.interval("x") is not NO_SPAN and StageTimer().interval("x") is NO_SPAN
