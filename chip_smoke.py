#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`orbslam3lib_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build: compile both CUDA kernels from `orbslam3lib_tpu_torch/csrc/` with
     nvcc (sm_90a, one process per source), print the build time and ptxas's
     registers, shared memory and spills per kernel;
  2. kernels: run each kernel against its plain PyTorch version on the card,
     at the shapes the main path gives it, and require bit equality
     (`torch.equal`): kernel 1 on single levels and, in one launch, on the
     rendered frame's 8 levels, on random levels at every FAST_SHAPES entry
     and on levels whose widths are not multiples of 4; kernel 2 on
     KNN_SHAPES (incl. one and more than 16,384 columns). Time each at the
     main path's shape: `ms` is device time per launch, from CUDA events
     around N_TIMED back-to-back launches captured in a CUDA graph (so the
     host's enqueueing cannot stretch it), `loop_ms` the same launches
     enqueued from a Python loop, `call_ms` the median of CUDA events
     around single calls of the wrapper (what the host sees per call,
     enqueueing included), `plain_ms` the plain version per call; kernel
     1's launch is a whole frame (8 levels, both eyes), and it is also
     timed on level 0 alone and as 8 one-level launches per frame. Each
     kernel's bound (bytes or operations of this run's inputs over the
     H100's published peaks) goes beside its time;
  3. slice: render the bench's orbit sequence (bench.py's world, trajectory,
     seed and 640x400 rig) with the port's numpy renderer and drive
     `Tracker.process_frame` over its first N_FRAMES frames (the orbit's
     period is 24 s, 360 frames: the camera comes back to its first views
     and the loop closes) on the card with bench.py's configuration (512
     keypoints, 8 levels, 2x2 pose iterations, 256 KF / 16384 MP map, the
     default local BA and local mapping), loop closing on: on every
     keyframe BoW add + local mapping + the loop probe, then local BA, then
     the loop closer on the probe's pack (verification, essential-graph
     correction and global BA on a confirmed loop). Before frame
     JOLT_FRAME, after the loop, the tracker's motion prior is replaced by
     a wrong one, as a jolt of the camera would, so that frame misses its
     inliers and takes the TrackReferenceKeyFrame fallback (kernel 2).
     Then a kidnap: the image of frame N_FRAMES - KIDNAP_BACK (half a
     revolution back) comes with the next timestamp, and two more frames
     after it; the motion model and the fallback fail on it and BoW
     relocalisation must find the pose (checked against the analytic pose
     through the keyframes' alignment to the orbit).
     Kernel launch counters are zeroed just before and read just after the
     frames; the back end's steps are timed by CUDA events (per keyframe:
     `mapper_step_fused`, its `loop_probe`, `map_window_ba`; per loop:
     `verify_loop_fused`, `LoopCloser.correct`, `global_bundle_adjust`),
     with torch's sync debug mode on around them. Checks: state OK, one
     track failure (the kidnapped frame), the jolted frame's fallback, the
     reference's loop count and keyframe pair, relocalisation of the
     kidnapped frame within KIDNAP_POSE_M of its analytic pose, one
     kernel-1 launch per frame (every level of both eyes), kernel 2 at
     least once per probed keyframe, local mapping once per keyframe
     after the first, local BA on every keyframe from the third on, neither `mapper_step_fused` (with its probe) nor local BA
     waiting on the card from the host, at most max_mp landmarks, finite
     poses, and the ATE of the trajectory and of the loop-corrected
     keyframes against the analytic orbit within their bounds.
  4. D, raw radial-tangential stereo: bench.py's `distorted` rig (DIST)
     on the orbit, N_RADTAN frames through `System(cfg, "stereo")
     .track_stereo` with `cfg.stereo.rectify`: the maps are built once, the
     remap runs on the card every frame without a host sync, kernel 1 once
     per frame and bit-exact on a rectified frame's 8 levels, state OK with
     no failure, the trajectory's ATE and the loops against the reference's
     (REF_RADTAN), and `save_trajectory_tum` writes a line per frame; the
     remap's device ms per frame is printed.
  5. F, two-camera Kannala-Brandt stereo (`cfg.stereo.fisheye`, the rig of
     tests/test_fisheye_stereo.py::test_e2e_kb8_stereo) on the orbit,
     N_KB8 frames through `System.track_stereo`: state OK, no failure,
     kernel 1 once per frame, ATE against the reference's (REF_KB8).
  6. C, compaction: the first N_COMPACT frames of phase 3's orbit with
     24 keyframe and 2,048 landmark slots and a keyframe on every frame,
     through `System.track_stereo`: at least one compaction, more than 36
     keyframes made, at most 24 held, state OK with no failure, and after
     every compaction the loop closer's and the database's ids inside the
     live slots.
  Phases 4-6 each reset the launch counters just before their frames and
  read them just after; each kernel must launch on each of them (counts in
  the kernels line, `launches_by_path`). The sequences render in three
  processes started before the card is used.

The last three lines of standard output are the card's name and power
limit (as nvidia-smi gives them), one JSON object with a row per kernel,
and the result line {"ok": true, "device": {...}}. Without a CUDA device it
exits non-zero and prints no result. Imports nothing of JAX. Reference
numbers: `tools/reference_smoke.py` (the JAX tracker on the CPU, same
frames and configurations).
"""
from __future__ import annotations

import json
import multiprocessing
import os
import re
import sys
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

N_FRAMES = 400
# The JAX reference on the CPU, on these frames with the jolt and the kidnap
# (`Tracker(cfg, "stereo", enable_loop_closing=True, pipeline=0)`, bench.py's
# configuration; tools/reference_smoke.py --phase pinhole): its first and
# only loop closes at frame 343, keyframe 27 against keyframe 1; ATE
# 0.034051 m on the trajectory and 0.019995 m on the corrected keyframes;
# the kidnapped frame relocalises. Bounds: x 1.5 + 5 mm (PERF.md).
REF_N_LOOPS = 1
REF_LOOP_EDGE = (1, 27)
ATE_BOUND_M = 0.0561
KF_ATE_BOUND_M = 0.0350
# The frame before which the constant-velocity prior is replaced by
# JOLT_PRIOR: 0.2 rad about the camera's y axis and 0.3 m sideways. Searched
# from there, the frame finds too few inliers; the fallback re-seeds from
# the reference keyframe and the last pose. It comes after the loop, so the
# frames up to the loop are the ones the reference ran.
JOLT_FRAME = 370
JOLT_PRIOR = ((0.0, 0.2, 0.0), (0.3, 0.0, 0.0))
# The kidnap: the image of frame N_FRAMES - KIDNAP_BACK, then the two after
# it, with the timestamps that follow the run's last.
KIDNAP_BACK = 180
KIDNAP_POSE_M = 0.05

# Phases D, F and C: bench.py's raw-rig distortion, the fisheye rig of
# tests/test_fisheye_stereo.py, and the compaction capacities of
# tests/test_compaction.py::test_long_sequence_with_recycling.
DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
KB8_RIG = dict(fx=285.0, fy=285.0, model="kannala_brandt8", k=(0.02, -0.01, 0.003, 0.0))
N_RADTAN = 400
N_KB8 = 180
N_COMPACT = 150
COMPACT_MAX_KF = 24
COMPACT_MAX_MP = 2048
# The JAX reference on the CPU at each phase's configuration and frames
# (tools/reference_smoke.py): trajectory ATE (m), loops and loop pair. The
# bounds are x 1.5 + 5 mm, as phase 3's.
REF_RADTAN = {"ate_m": 0.034740, "n_loops": 1, "loop_edges": [[0, 27]]}   # loop at frame 343
REF_KB8 = {"ate_m": 0.015875}                                             # no loop in 180 frames
REF_COMPACT = {"ate_m": 0.027008}                                         # 147 KFs, 28 compactions

FAST_SHAPES = [(400, 640), (320, 512), (240, 384), (196, 314), (160, 256),
               (127, 203), (101, 161), (80, 128)]
# level lists whose widths are not multiples of 4 (kernel 1 in one launch)
ODD_SHAPES = [(127, 203), (101, 161), (196, 314), (37, 61), (5, 7), (1, 1)]
KNN_SHAPES = [(64, 64, True), (300, 450, True), (512, 1024, True),
              (100, 200, False), (512, 512, True), (1, 1, True),
              (33, 3000, True), (3, 16500, True)]
N_TIMED = 200
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
# memory bytes per second,
# and f32 operations per second outside the tensor cores, used for kernel
# 2's integer XOR/POPC/ADD too (the table has no integer rate).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per interior pixel of kernel 1 (2 x 79 in the arc networks, 2
# subtractions, 2 for the floor, 9 for the NMS; csrc/fast_nms.cu's note)
# and per (row, column) pair of kernel 2 (8 XOR, 8 POPC, 8 ADD, 2 for the
# running minimum)
FAST_OPS_PER_PIXEL = 171
KNN_OPS_PER_PAIR = 26


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def call_ms(fn, n: int = 100, warm: int = 10) -> float:
    """Median of CUDA events around single calls of fn() in ms: on an idle
    card this spans what the host does to enqueue the call."""
    for _ in range(warm):
        fn()
    ev = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def bound(n_bytes: float, n_ops: float):
    """(bound ms, what sets it): the larger of the bytes over the memory
    rate and the operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fast_bound(levels, margin: int):
    """Kernel 1 over these levels: each f32 pixel read once and written
    once; the networks and the NMS on every interior pixel."""
    n_px = sum(l.numel() for l in levels)
    n_in = sum(l.shape[0] * max(0, l.shape[1] - 2 * margin) * max(0, l.shape[2] - 2 * margin)
               for l in levels)
    return bound(8.0 * n_px, FAST_OPS_PER_PIXEL * n_in)


def knn_bound(na: int, nb: int, masked: bool):
    """Kernel 2: the int8 bits (and masks) read once, (best, d1, d2)
    written once; the popcount distance of every pair."""
    n_bytes = (na + nb) * (256 + int(masked)) + 12 * na
    return bound(n_bytes, KNN_OPS_PER_PAIR * na * nb)


def check_fast(dev, gen, rendered_levels):
    """Kernel 1 vs nms3x3(fast_scores(.)) on the card: every level shape at
    DETECT_MARGIN and 64x128 at margin 3, random and rendered images, one
    level per launch; then every level of a list in one launch: the
    rendered frame's, random ones at every FAST_SHAPES entry, and levels
    whose widths are not multiples of 4."""
    from orbslam3lib_tpu_torch.ops import cuda_fast
    from orbslam3lib_tpu_torch.ops.extractor import DETECT_MARGIN
    cases = [(torch.randint(0, 256, (2, h, w), generator=gen, dtype=torch.uint8),
              DETECT_MARGIN) for h, w in FAST_SHAPES]
    cases.append((torch.rand((64, 128), generator=gen) * 255.0, 3))
    cases += [(lvl, DETECT_MARGIN) for lvl in rendered_levels]
    err = 0.0
    for img, margin in cases:
        x = img.to(dev)
        got = cuda_fast.fast_scores_nms(x, margin)
        want = cuda_fast.fast_scores_nms_plain(x, margin)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fast_scores_nms differs at {tuple(x.shape)} "
                                 f"margin {margin}: max err {max_err(got, want)}")
        err = max(err, max_err(got, want))
    level_lists = {
        "rendered frame": list(rendered_levels),
        "FAST_SHAPES": [torch.randint(0, 256, (2, h, w), generator=gen,
                                      dtype=torch.uint8).float() for h, w in FAST_SHAPES],
        "odd widths": [torch.rand((2, h, w), generator=gen) * 255.0 for h, w in ODD_SHAPES],
    }
    for name, levels in level_lists.items():
        x = [l.to(dev) for l in levels]
        before = cuda_fast.launches
        got = cuda_fast.fast_scores_nms_levels(x, DETECT_MARGIN)
        want = cuda_fast.fast_scores_nms_levels_plain(x, DETECT_MARGIN)
        torch.cuda.synchronize()
        if cuda_fast.launches != before + 1:
            raise AssertionError(f"fast_scores_nms_levels ({name}) made "
                                 f"{cuda_fast.launches - before} launches")
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"fast_scores_nms_levels ({name}) differs at "
                                     f"{tuple(g.shape)}: max err {max_err(g, w)}")
            err = max(err, max_err(g, w))
    log(f"[smoke] kernel 1 bit-exact on {len(cases)} one-level cases and "
        f"{len(level_lists)} level lists in one launch each")
    return err


def time_fast(levels):
    """Kernel 1 on one rendered frame's levels (f32 on the card): device ms
    per launch of the whole frame (graph and loop), of level 0 alone, and of
    the frame as 8 one-level launches; the wrapper's call_ms; the plain
    version per frame; the bound."""
    from orbslam3lib_tpu_torch.device import device_ms_per_launch
    from orbslam3lib_tpu_torch.ops import cuda_fast
    from orbslam3lib_tpu_torch.ops.extractor import DETECT_MARGIN
    _, frame = cuda_fast.prepare_launch(levels, DETECT_MARGIN)
    _, level0 = cuda_fast.prepare_launch(levels[:1], DETECT_MARGIN)
    singles = [cuda_fast.prepare_launch([l], DETECT_MARGIN)[1] for l in levels]

    def eight():
        for launch in singles:
            launch()

    t = {"frame_ms": device_ms_per_launch(frame, N_TIMED, graph=True),
         "loop_ms": device_ms_per_launch(frame, N_TIMED),
         "level0_ms": device_ms_per_launch(level0, N_TIMED, graph=True),
         "one_level_launches_ms": device_ms_per_launch(eight, N_TIMED, graph=True),
         "call_ms": call_ms(lambda: cuda_fast.fast_scores_nms_levels(levels, DETECT_MARGIN)),
         "plain_ms": device_ms_per_launch(
             lambda: cuda_fast.fast_scores_nms_levels_plain(levels, DETECT_MARGIN), 50, 5)}
    t["ms"] = t["frame_ms"]
    t["bound_ms"], t["bound_by"] = fast_bound(levels, DETECT_MARGIN)
    t["level0_bound_ms"] = fast_bound(levels[:1], DETECT_MARGIN)[0]
    return t


def check_knn_pair(a, b, av, bv):
    from orbslam3lib_tpu_torch.ops import cuda_matcher, matcher
    before = cuda_matcher.launches
    got = cuda_matcher.knn_match_fused(a, b, av, bv)
    want = matcher.knn_match(a, b, av, bv)
    torch.cuda.synchronize()
    if cuda_matcher.launches != before + 1:
        raise AssertionError(f"knn_match_fused made {cuda_matcher.launches - before} launches")
    for g, w, name in zip(got, want, ("best", "d1", "d2")):
        if not torch.equal(g, w):
            raise AssertionError(f"knn_match_fused {name} differs at "
                                 f"{tuple(a.shape)}x{tuple(b.shape)}")
    return max(max_err(g, w) for g, w in zip(got, want))


def random_bits(gen, dev, na: int, nb: int, masked: bool):
    a = (torch.rand((na, 256), generator=gen) < 0.5).to(torch.int8).to(dev)
    b = (torch.rand((nb, 256), generator=gen) < 0.5).to(torch.int8).to(dev)
    av = (torch.rand(na, generator=gen) < 0.9).to(dev) if masked else None
    bv = (torch.rand(nb, generator=gen) < 0.9).to(dev) if masked else None
    return a, b, av, bv


def check_knn(dev, gen):
    """Kernel 2 vs the plain Hamming product + knn2 on the card."""
    err = 0.0
    for na, nb, masked in KNN_SHAPES:
        err = max(err, check_knn_pair(*random_bits(gen, dev, na, nb, masked)))
    log(f"[smoke] kernel 2 bit-exact on {len(KNN_SHAPES)} random cases, one launch each")
    return err


def time_knn(dev, gen):
    """Kernel 2 at the main path's 512 x 512 (masked): as time_fast."""
    from orbslam3lib_tpu_torch.device import device_ms_per_launch
    from orbslam3lib_tpu_torch.ops import cuda_matcher, matcher
    a, b, av, bv = random_bits(gen, dev, 512, 512, True)
    _, launch = cuda_matcher.prepare_launch(a, b, av.view(torch.uint8), bv.view(torch.uint8))
    t = {"ms": device_ms_per_launch(launch, N_TIMED, graph=True),
         "loop_ms": device_ms_per_launch(launch, N_TIMED),
         "call_ms": call_ms(lambda: cuda_matcher.knn_match_fused(a, b, av, bv)),
         "plain_ms": device_ms_per_launch(lambda: matcher.knn_match(a, b, av, bv), 50, 5)}
    t["bound_ms"], t["bound_by"] = knn_bound(512, 512, True)
    return t


def ptxas_report(log_text: str):
    """Per kernel (demangled-ish name): registers, shared memory bytes and
    spill stores/loads, from nvcc -Xptxas -v."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in ("fast_nms_levels_kernel", "knn2_kernel")
                         if k in m.group(1)), m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


class StepTimer:
    """Wraps a back-end step: CUDA events around each call (read after the
    run, so timing adds no wait) and torch's sync debug mode, which warns
    at every point where the host would wait on the card. Nested timers
    each keep the waits inside their own call."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []
        self.syncs = []

    def __call__(self, *args, **kwargs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                s.record()
                out = self.fn(*args, **kwargs)
                e.record()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        self.syncs += [str(w.message) for w in caught
                       if "called a synchronizing" in str(w.message)]
        self.events.append((s, e))
        return out

    def ms(self):
        return [s.elapsed_time(e) for s, e in self.events]


def stage_line(name: str, ms_list) -> str:
    v = np.asarray(ms_list)
    if not len(v):
        return f"{name}: not run"
    return (f"{name} median {np.median(v):.3f}, p90 {np.percentile(v, 90):.3f}, "
            f"max {np.max(v):.3f} over {len(v)}")


def kf_ate(m, origin: float):
    """ATE of the map's valid keyframes against the analytic orbit at their
    timestamps, and the alignment (R, t) of the map's frame onto the
    world's that it uses."""
    from orbslam3lib_tpu_torch.evaluation import ate_rmse, umeyama_alignment
    from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at
    v = m.kf_valid.cpu().numpy()
    R, t = m.kf_R.cpu().numpy()[v], m.kf_t.cpu().numpy()[v]
    kf_ts = m.kf_ts.cpu().numpy()[v].astype(np.float64) + origin
    est = -np.einsum("kji,kj->ki", R, t)
    gt = orbit_pose_at(kf_ts, period=24.0, radius=0.5)[1]
    _, R_a, t_a = umeyama_alignment(est, gt)
    return ate_rmse(est, gt), (R_a, t_a)


def render(n: int, rig_kw: dict):
    """bench.py's orbit sequence for a StereoRig(**rig_kw) (numpy only; runs
    in a worker process)."""
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, render_orbit_sequence
    t0 = time.perf_counter()
    imgs, ts, rig = render_orbit_sequence(n, StereoRig(**rig_kw))
    return imgs, ts, rig, time.perf_counter() - t0


def ate_within(ate: float, ref) -> bool:
    """ATE against the reference's x 1.5 + 5 mm."""
    return ref is not None and ate <= 1.5 * ref + 0.005


def run_system(cfg, frames, dev, setup=None):
    """Drive `System(cfg, "stereo").track_stereo` over (image, stamp)
    frames on the card, each frame synchronised. `setup(system)` runs after
    the system is built and before the counters are zeroed. Returns the
    system, the per-frame results and host ms, and the kernel launches made
    during the frames."""
    from orbslam3lib_tpu_torch.ops import cuda_fast, cuda_matcher
    from orbslam3lib_tpu_torch.system import System
    sys_ = System(cfg, "stereo", device=dev)
    if setup is not None:
        setup(sys_)
    torch.cuda.synchronize()
    cuda_fast.reset_count()
    cuda_matcher.reset_count()
    results, frame_ms = [], []
    for img, stamp in frames:
        t0 = time.perf_counter()
        results.append(sys_.track_stereo(img, stamp))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"fast_scores_nms": cuda_fast.launches,
                "knn_match_fused": cuda_matcher.launches}
    sys_.shutdown()
    return sys_, results, frame_ms, launches


def trajectory_ate(tracker, ts) -> float:
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at
    c = tracker.trajectory_centers()
    t = np.asarray([f[0] for f in tracker.trajectory])
    return ate_rmse(c, orbit_pose_at(t, period=24.0, radius=0.5)[1]) if len(c) >= 3 \
        else float("inf")


def path_line(name, frame_ms, sys_, launches, ate, extra="") -> str:
    st = sys_.get_stats()
    return (f"[smoke] {name}: {len(frame_ms)} frames, median {np.median(frame_ms):.2f} ms, "
            f"p90 {np.percentile(frame_ms, 90):.2f} ms per frame; KFs {st['n_kf']} made, "
            f"map {sys_.map_info()}; track_fail {st['track_fail']}, loops {st['n_loops']} "
            f"{sys_.tracker.loop_closer.loop_edges}; ATE {ate:.6f} m; launches {launches}"
            + extra)


def phase_radtan(dev, imgs, ts):
    """Phase D: the raw radial-tangential pair rectified on the card."""
    from orbslam3lib_tpu_torch.device import device_ms_per_launch
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, orbit_tracking_config
    from orbslam3lib_tpu_torch.ops import cuda_fast, pyramid
    from orbslam3lib_tpu_torch.ops.extractor import DETECT_MARGIN
    from orbslam3lib_tpu_torch.utils import rectify
    rig = StereoRig(dist=DIST)
    cfg = orbit_tracking_config(rig)
    cfg.camera.dist = DIST
    cfg.stereo.rectify = True
    builds = []
    real_rectify = rectify.stereo_rectify
    rectify.stereo_rectify = lambda *a, **k: builds.append(1) or real_rectify(*a, **k)
    box = {}

    def setup(sys_):
        box["remap"] = sys_.tracker._remap
        box["timer"] = StepTimer(sys_.tracker._remap)
        sys_.tracker._remap = box["timer"]

    try:
        sys_, results, frame_ms, launches = run_system(
            cfg, [(imgs[i], float(ts[i])) for i in range(len(imgs))], dev, setup)
    finally:
        rectify.stereo_rectify = real_rectify
    tr, remap = sys_.tracker, box["remap"]
    # kernel 1 on a rectified frame's 8 levels, bit-exact (after the counts)
    raw = torch.as_tensor(imgs[len(imgs) // 2], device=dev)
    levels = pyramid.build_pyramid(remap(raw), 8)
    got = cuda_fast.fast_scores_nms_levels(levels, DETECT_MARGIN)
    want = cuda_fast.fast_scores_nms_levels_plain(levels, DETECT_MARGIN)
    torch.cuda.synchronize()
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(max_err(g, w) for g, w in zip(got, want))
    frac = bool((levels[0] != torch.round(levels[0])).any())
    remap_ms = device_ms_per_launch(lambda: remap(raw), N_TIMED, graph=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "radtan_tum.txt")
        sys_.save_trajectory_tum(path)
        n_lines = len(open(path).read().strip().splitlines())
    ate = trajectory_ate(tr, ts)
    st = sys_.get_stats()
    log(path_line("D (raw radtan stereo, rectified on the card)", frame_ms, sys_,
                  launches, ate,
                  f"; remap: {len(box['timer'].events)} calls, host syncs "
                  f"{len(box['timer'].syncs)}, device {remap_ms:.5f} ms per frame (graph of "
                  f"{N_TIMED}); maps built {len(builds)} time(s); rectified camera "
                  f"{cfg.camera.params.tolist()}, baseline {cfg.stereo.baseline:.6f}"))
    print(f"D radtan: median {np.median(frame_ms):.2f} ms, p90 "
          f"{np.percentile(frame_ms, 90):.2f} ms per frame; remap device "
          f"{remap_ms:.5f} ms per frame; ATE {ate:.6f} m")
    ref = REF_RADTAN
    checks = {
        "D: maps built once": len(builds) == 1,
        "D: remap on every frame, no host sync":
            len(box["timer"].events) == len(imgs) and not box["timer"].syncs,
        "D: kernel 1 once per frame": launches["fast_scores_nms"] == len(imgs),
        "D: kernel 2 launched": launches["knn_match_fused"] >= 1,
        "D: kernel 1 bit-exact on a rectified frame (fractional level 0)": exact and frac,
        "D: state OK, no failure": all(r["state"] == 1 for r in results)
            and st["track_fail"] == 0,
        "D: ATE within the reference's bound": ate_within(ate, ref["ate_m"]),
        "D: the reference's loops": st["n_loops"] == ref["n_loops"]
            and [list(e) for e in tr.loop_closer.loop_edges] == ref["loop_edges"],
        "D: one TUM line per frame": n_lines == len(imgs),
    }
    return checks, launches, err


def phase_kb8(dev, imgs, ts):
    """Phase F: two-camera Kannala-Brandt stereo."""
    from orbslam3lib_tpu_torch.config import CameraConfig
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, orbit_tracking_config
    rig = StereoRig(**KB8_RIG)
    cfg = orbit_tracking_config(rig)
    cfg.camera = CameraConfig(model="kannala_brandt8", fx=rig.fx, fy=rig.fy, cx=rig.cx,
                              cy=rig.cy, k=tuple(rig.k), width=rig.width, height=rig.height)
    cfg.stereo.fisheye = True
    sys_, results, frame_ms, launches = run_system(
        cfg, [(imgs[i], float(ts[i])) for i in range(len(imgs))], dev)
    ate = trajectory_ate(sys_.tracker, ts)
    st = sys_.get_stats()
    log(path_line("F (two-camera KB8 stereo)", frame_ms, sys_, launches, ate))
    print(f"F kb8: median {np.median(frame_ms):.2f} ms, p90 "
          f"{np.percentile(frame_ms, 90):.2f} ms per frame; ATE {ate:.6f} m")
    checks = {
        "F: state OK, no failure": all(r["state"] == 1 for r in results)
            and st["track_fail"] == 0,
        "F: kernel 1 once per frame": launches["fast_scores_nms"] == len(imgs),
        "F: kernel 2 launched": launches["knn_match_fused"] >= 1,
        "F: ATE within the reference's bound": ate_within(ate, REF_KB8["ate_m"]),
    }
    return checks, launches


def phase_compact(dev, imgs, ts, rig):
    """Phase C: compaction at small capacities with dense keyframing."""
    from orbslam3lib_tpu_torch.io.synthetic import orbit_tracking_config
    cfg = orbit_tracking_config(rig)
    cfg.map.max_kf = COMPACT_MAX_KF
    cfg.map.max_mp = COMPACT_MAX_MP
    cfg.ba.max_points = 1024              # local BA's points must fit the slots
    cfg.tracker.min_frames_between_kf = 1
    cfg.tracker.kf_ref_ratio = 10.0
    ids_ok = []

    def setup(sys_):
        tr = sys_.tracker
        real = tr._compact_map

        def checked():
            done = real()
            if done:
                n, lc = int(tr.map.n_kf), tr.loop_closer
                ids_ok.append(
                    all(0 <= i < n and 0 <= j < n for i, j in lc.loop_edges)
                    and lc.last_loop_kf < n and 0 <= tr.last_kf_id < n
                    and torch.equal(tr.place_rec.active, tr.map.kf_valid))
            return done
        tr._compact_map = checked

    sys_, results, frame_ms, launches = run_system(
        cfg, [(imgs[i], float(ts[i])) for i in range(len(imgs))], dev, setup)
    ate = trajectory_ate(sys_.tracker, ts)
    st = sys_.get_stats()
    log(path_line("C (compaction, 24 KF / 2048 MP slots)", frame_ms, sys_, launches, ate,
                  f"; compactions {st['n_compactions']}, ids valid after each: {ids_ok}"))
    print(f"C compaction: median {np.median(frame_ms):.2f} ms, p90 "
          f"{np.percentile(frame_ms, 90):.2f} ms per frame; {st['n_compactions']} "
          f"compactions; {st['n_kf']} KFs made; ATE {ate:.6f} m")
    checks = {
        "C: at least one compaction": st["n_compactions"] >= 1,
        "C: more than 36 keyframes made": st["n_kf"] > 36,
        "C: at most 24 keyframes held": int(sys_.tracker.map.n_kf) <= COMPACT_MAX_KF,
        "C: state OK, no failure": all(r["state"] == 1 for r in results)
            and st["track_fail"] == 0,
        "C: loop closer and database ids valid after each compaction":
            bool(ids_ok) and all(ids_ok),
        "C: kernel 1 once per frame": launches["fast_scores_nms"] == len(imgs),
        "C: kernel 2 launched": launches["knn_match_fused"] >= 1,
        "C: ATE within the reference's bound": ate_within(ate, REF_COMPACT["ate_m"]),
    }
    return checks, launches


def main() -> int:
    if not torch.cuda.is_available():
        log("[smoke] CUDA is not available: this smoke test needs one CUDA card")
        return 2
    t_start = time.perf_counter()
    # the sequences render in worker processes, forked before CUDA is used
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("fork"))
    try:
        jobs = {"pinhole": pool.submit(render, N_FRAMES, {}),
                "radtan": pool.submit(render, N_RADTAN, {"dist": DIST}),
                "kb8": pool.submit(render, N_KB8, KB8_RIG)}
        return run(jobs, t_start)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run(jobs, t_start) -> int:
    from orbslam3lib_tpu_torch.device import card_line, device_ms_per_launch
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at, orbit_tracking_config
    from orbslam3lib_tpu_torch.mapping import loop_closing as lc_mod
    from orbslam3lib_tpu_torch.ops import _cuda_lib, cuda_fast, cuda_matcher, pyramid
    from orbslam3lib_tpu_torch.ops.extractor import extract_orb_stereo
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    from orbslam3lib_tpu_torch.tracking.tracker import OK, Tracker
    from orbslam3lib_tpu_torch.utils import lie

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[smoke] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build --------------------------------------------------------
    build_s = _cuda_lib.build()
    _cuda_lib.library()
    ptxas = ptxas_report(_cuda_lib.BUILD_LOG)
    log(f"[smoke] built {', '.join(_cuda_lib.SOURCES)} with nvcc in {build_s:.2f} s; "
        f"ptxas: {ptxas}")

    # -- 2. kernels vs their plain versions --------------------------------
    t0 = time.perf_counter()
    imgs, ts, rig, render_s = jobs["pinhole"].result()
    log(f"[smoke] rendered {N_FRAMES} stereo frames in {render_s:.1f} s (waited "
        f"{time.perf_counter() - t0:.1f} s)")
    gen = torch.Generator().manual_seed(0)
    rendered = pyramid.build_pyramid(torch.as_tensor(imgs[0], device=dev), 8)
    fast_err = check_fast(dev, gen, rendered)
    knn_err = check_knn(dev, gen)
    fast_t = time_fast(rendered)
    knn_t = time_knn(dev, gen)
    log(f"[smoke] fast_scores_nms_levels (one frame: 8 levels x 2 eyes, 640x400), ms: "
        + ", ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in fast_t.items()))
    log("[smoke] knn_match_fused (512x512), ms: "
        + ", ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in knn_t.items()))

    cfg = orbit_tracking_config(rig)
    img0 = torch.as_tensor(imgs[0], device=dev)

    def extract():
        return extract_orb_stereo(img0, 17.0, max_kp=512, n_levels=8, return_canvas=True)

    extract_ms = call_ms(extract, n=30, warm=3)
    extract_loop_ms = device_ms_per_launch(extract, 30, 3)
    log(f"[smoke] extract_orb_stereo (2x400x640, 512 kp, 8 levels): "
        f"{extract_ms:.3f} ms per frame (events around each call), "
        f"{extract_loop_ms:.3f} ms per frame over 30 back-to-back frames")

    # -- 3. the slice: frames in, poses out ---------------------------------
    timers = {"mapper_step_fused": StepTimer(ttr.mapper_step_fused),
              "loop_probe": StepTimer(lc_mod.loop_probe),
              "map_window_ba": StepTimer(ttr._local_ba),
              "verify_loop_fused": StepTimer(lc_mod.verify_loop_fused),
              "correct": StepTimer(lc_mod.LoopCloser.correct),
              "global_bundle_adjust": StepTimer(lc_mod.global_bundle_adjust)}
    ttr.mapper_step_fused, ttr._local_ba = timers["mapper_step_fused"], timers["map_window_ba"]
    lc_mod.loop_probe = timers["loop_probe"]
    lc_mod.verify_loop_fused = timers["verify_loop_fused"]
    lc_mod.global_bundle_adjust = timers["global_bundle_adjust"]
    correct_t = timers["correct"]
    originals = (ttr.mapper_step_fused, ttr._local_ba, lc_mod.loop_probe,
                 lc_mod.verify_loop_fused, lc_mod.global_bundle_adjust,
                 lc_mod.LoopCloser.correct)
    lc_mod.LoopCloser.correct = lambda self, *a, **k: correct_t(self, *a, **k)
    tracker = Tracker(cfg, sensor="stereo", device=dev)
    jolt = (lie.so3_exp(torch.tensor(JOLT_PRIOR[0], device=dev)),
            torch.tensor(JOLT_PRIOR[1], device=dev))
    dt = float(ts[1] - ts[0])
    kid = N_FRAMES - KIDNAP_BACK
    frames = [(imgs[i], float(ts[i])) for i in range(N_FRAMES)] + \
        [(imgs[kid + i], float(ts[-1]) + (i + 1) * dt) for i in range(3)]
    torch.cuda.synchronize()
    cuda_fast.reset_count()
    cuda_matcher.reset_count()
    frame_ms, results, loop_frame, kf_ate_m, loop_pair = [], [], None, None, None
    for i, (img, stamp) in enumerate(frames):
        if i == JOLT_FRAME:
            tracker.vel = jolt
        t0 = time.perf_counter()
        res = tracker.process_frame(img, stamp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
        if loop_frame is None and tracker.stats["n_loops"] > 0:
            loop_frame = i
        if i == N_FRAMES - 1:
            # before the kidnap's frames can add keyframes at their stamps
            kf_ate_m, align = kf_ate(tracker.map, float(ts[0]))
            traj_before = tracker.trajectory_centers()
            fail_before = tracker.stats["track_fail"]
            loop_pair = list(tracker.loop_closer.loop_edges)
    launches = {"fast_scores_nms": cuda_fast.launches,
                "knn_match_fused": cuda_matcher.launches}
    torch.cuda.synchronize()
    # the later phases run unpatched
    (ttr.mapper_step_fused, ttr._local_ba, lc_mod.loop_probe, lc_mod.verify_loop_fused,
     lc_mod.global_bundle_adjust, lc_mod.LoopCloser.correct) = originals

    st = tracker.stats
    med, p90 = np.percentile(frame_ms, 50), np.percentile(frame_ms, 90)
    n_alive = int(tracker.map.kf_valid.sum())
    log(f"[smoke] slice: {len(frames)} frames, median {med:.2f} ms, p90 {p90:.2f} ms "
        f"per frame (first {frame_ms[0]:.1f} ms); KFs {st['n_kf']} created, "
        f"{n_alive} alive; landmarks {int(tracker.map.n_mp)}, track_fail "
        f"{st['track_fail']}, ref-KF fallbacks {st['ref_kf_fallbacks']} (jolted "
        f"frame {JOLT_FRAME}: {results[JOLT_FRAME]}, {frame_ms[JOLT_FRAME]:.2f} ms); "
        f"mapping steps {st['n_mapping_steps']}, local BAs {st['n_local_ba']}; "
        f"launches {launches}")
    lcr = tracker.loop_closer
    ver = lcr.last_verification
    log(f"[smoke] loops {st['n_loops']} (first at frame {loop_frame}, "
        f"{frame_ms[loop_frame] if loop_frame is not None else float('nan'):.1f} ms "
        f"that frame), loop edges {loop_pair}, loop_latency_ms "
        f"{st.get('loop_latency_ms')}; last verification "
        f"{None if ver is None else (ver[0], ver[1], ver[2][:5].tolist(), float(ver[2][17]))}")
    per = {name: t.ms() for name, t in timers.items()}
    print("per-keyframe device ms (CUDA events): " + "; ".join(
        stage_line(n, per[n]) for n in ("mapper_step_fused", "loop_probe", "map_window_ba")))
    print("per-loop device ms (CUDA events): " + "; ".join(
        stage_line(n, per[n]) for n in ("verify_loop_fused", "correct",
                                         "global_bundle_adjust"))
          + f"; loop_latency_ms (host, keyframe to corrected map) "
            f"{st.get('loop_latency_ms')}")
    syncs = {name: len(t.syncs) for name, t in timers.items()}
    log(f"[smoke] host syncs per step (sync debug mode): {syncs}")
    back_end_syncs = (timers["mapper_step_fused"].syncs + timers["loop_probe"].syncs
                      + timers["map_window_ba"].syncs)
    if back_end_syncs:
        log(f"[smoke] host syncs in the back end: {len(back_end_syncs)}; "
            f"first: {back_end_syncs[:3]}")

    t_traj = np.asarray([f[0] for f in tracker.trajectory[:N_FRAMES]])
    _, gt = orbit_pose_at(t_traj, period=24.0, radius=0.5)
    ate = ate_rmse(traj_before, gt) if len(traj_before) >= 3 else float("inf")
    log(f"[smoke] ATE {ate:.6f} m over {len(traj_before)} frames (bound {ATE_BOUND_M} m); "
        f"keyframe ATE {kf_ate_m:.6f} m (bound {KF_ATE_BOUND_M} m)")

    # the kidnapped frame: its camera centre against the analytic one, the
    # map carried onto the world by the keyframe ATE's alignment (the loop
    # correction moves the map's gauge off the first camera)
    c_true = orbit_pose_at(np.array([ts[kid]]), period=24.0, radius=0.5)[1][0]
    _, R_k, t_k = tracker.trajectory[N_FRAMES]
    kid_err = float(np.linalg.norm(align[0] @ (-R_k.T @ t_k) + align[1] - c_true))
    R_cw, c_w = orbit_pose_at(np.array([ts[0], ts[kid]]), period=24.0, radius=0.5)
    kid_err_first = float(np.linalg.norm(-R_k.T @ t_k - R_cw[0].T @ (c_w[1] - c_w[0])))
    kid_res = results[N_FRAMES]
    log(f"[smoke] kidnap (image of frame {kid} at frame {N_FRAMES}): {kid_res}, "
        f"{frame_ms[N_FRAMES]:.1f} ms; pose {kid_err:.4f} m from the analytic one "
        f"({kid_err_first:.4f} m in the first camera's frame, unaligned); "
        f"after: {[r['state'] for r in results[N_FRAMES + 1:]]}")

    # kernel 2 on real descriptors: the last frame's against the last
    # keyframe's (after the counters were read)
    feats = extract_orb_stereo(
        torch.as_tensor(frames[-1][0], device=dev), float(np.float32(tracker.threshold.t)),
        max_kp=cfg.orb.max_kp, n_levels=cfg.orb.n_levels)
    kf = tracker.last_kf_id
    knn_err = max(knn_err, check_knn_pair(
        feats.desc[0], tracker.map.kf_desc[kf], feats.valid[0],
        tracker.map.kf_feat_valid[kf] & (tracker.map.kf_mp[kf] >= 0)))
    log("[smoke] kernel 2 bit-exact on the last frame's descriptors vs the last keyframe's")

    centers = tracker.trajectory_centers()
    n_probes = len(timers["loop_probe"].events)
    checks = {
        "state OK": tracker.state == OK and all(r["state"] == OK for r in results[N_FRAMES:]),
        "no track failure before the kidnap": fail_before == 0,
        "one track failure in all (the kidnapped frame)": st["track_fail"] == 1,
        "jolted frame took the ref-KF fallback and tracked":
            st["ref_kf_fallbacks"] >= 1 and results[JOLT_FRAME]["state"] == OK,
        "the reference's loops": st["n_loops"] == REF_N_LOOPS
            and loop_pair == [REF_LOOP_EDGE],
        "kidnapped frame relocalised": st["n_reloc"] >= 1 and bool(kid_res.get("reloc")),
        "relocalised pose near the analytic one": kid_err <= KIDNAP_POSE_M,
        "local mapping on every keyframe after the first":
            st["n_mapping_steps"] == len(timers["mapper_step_fused"].events)
            == st["n_kf"] - 1,
        "local BA on every keyframe from the third on":
            st["n_local_ba"] == len(timers["map_window_ba"].events) == st["n_kf"] - 2,
        "the probe on every keyframe's mapper step": n_probes == st["n_mapping_steps"],
        "no host sync in the back end (mapper step with its probe, local BA)":
            not back_end_syncs,
        "landmarks within max_mp": 0 < int(tracker.map.n_mp) <= cfg.map.max_mp,
        "kernel 1 once per frame":
            launches["fast_scores_nms"] == len(frames),
        "kernel 2 at least once per probed keyframe": launches["knn_match_fused"] >= n_probes,
        "finite poses": bool(np.isfinite(centers).all()) and len(centers) == len(frames),
        "ATE within bound": ate <= ATE_BOUND_M,
        "keyframe ATE within bound": kf_ate_m <= KF_ATE_BOUND_M,
    }

    # -- 4-6. the distorted rigs and compaction, through System ---------------
    by_path = {"stereo": launches}
    imgs_d, ts_d, _, render_d = jobs["radtan"].result()
    c, by_path["radtan"], rect_err = phase_radtan(dev, imgs_d, ts_d)
    checks.update(c)
    fast_err = max(fast_err, rect_err)
    del imgs_d
    imgs_f, ts_f, _, render_f = jobs["kb8"].result()
    c, by_path["kb8"] = phase_kb8(dev, imgs_f, ts_f)
    checks.update(c)
    del imgs_f
    c, by_path["compaction"] = phase_compact(dev, imgs[:N_COMPACT], ts[:N_COMPACT], rig)
    checks.update(c)
    for path, counts in by_path.items():
        for name, n in counts.items():
            checks[f"{name} launched on the {path} path"] = n >= 1
    log(f"[smoke] rendering (in worker processes): radtan {render_d:.1f} s, kb8 "
        f"{render_f:.1f} s; command so far {time.perf_counter() - t_start:.1f} s")

    failed = [k for k, v in checks.items() if not v]
    if failed:
        log(f"[smoke] FAILED: {failed}")
        return 1

    src = "orbslam3lib_tpu_torch/csrc/"
    kernels = {"kernels": [
        {"name": "fast_scores_nms", "route": "cuda", "source": src + "fast_nms.cu",
         "replaces": "orbslam3lib_tpu/ops/pallas_fast.py:92",
         "launches": launches["fast_scores_nms"], "max_abs_err": fast_err,
         **fast_t, "library_ms": None, "ptxas": ptxas.get("fast_nms_levels_kernel"),
         "launches_by_path": {p: c["fast_scores_nms"] for p, c in by_path.items()}},
        {"name": "knn_match_fused", "route": "cuda", "source": src + "knn2.cu",
         "replaces": "orbslam3lib_tpu/ops/pallas_matcher.py:77",
         "launches": launches["knn_match_fused"], "max_abs_err": knn_err,
         **knn_t, "library_ms": None, "ptxas": ptxas.get("knn2_kernel"),
         "launches_by_path": {p: c["knn_match_fused"] for p, c in by_path.items()}},
    ]}
    log(f"[smoke] total command time {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
