#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`orbslam3lib_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build: compile both CUDA kernels from `orbslam3lib_tpu_torch/csrc/` with
     nvcc (sm_90a) and print the build time;
  2. kernels: run each kernel against its plain PyTorch version on the card,
     at the shapes the main path gives it, and require bit equality
     (`torch.equal`); time both at the main-path shape (CUDA events, median);
  3. slice: render the bench's orbit sequence (bench.py's world, trajectory,
     seed and 640x400 rig) with the port's numpy renderer and drive
     `Tracker.process_frame` over its first N_FRAMES frames (12 s, half the
     orbit: no revisit, so no loop) on the card with bench.py's
     configuration (512 keypoints, 8 levels, 2x2 pose iterations, 256 KF /
     16384 MP map, the default local BA and local mapping), the synchronous
     back end on every keyframe: BoW add + local mapping, then local BA.
     Before frame JOLT_FRAME the tracker's motion prior is replaced by a
     wrong one, as a jolt of the camera would, so that frame misses its
     inliers and takes the TrackReferenceKeyFrame fallback (kernel 2).
     Kernel launch counters are zeroed just before and read just after the
     frames; the back end's two steps (`mapper_step_fused`, `map_window_ba`)
     are timed per keyframe by CUDA events, with torch's sync debug mode
     on around them. Checks: final state OK, no track failure, >= 10
     keyframes (the 8 + 2 BA window fills), the fallback taken, one
     kernel-1 launch per pyramid level per frame (both eyes share a launch),
     kernel 2 launched, local mapping once per keyframe after the first,
     local BA on every keyframe from the third on, neither back-end step
     waiting on the card from the host, at most max_mp landmarks, finite
     poses and ATE against the analytic trajectory within ATE_BOUND_M.

The last three lines of standard output are the card's name and power
limit (as nvidia-smi gives them), one JSON object with a row per kernel,
and the result line {"ok": true, "device": {...}}. Without a CUDA device it
exits non-zero and prints no result. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
import time
import warnings

import numpy as np
import torch

N_FRAMES = 180
# ATE bound (m): the JAX reference's CPU ATE on the same 180 frames with the
# same jolt (`Tracker(cfg, "stereo", enable_loop_closing=False, pipeline=0)`,
# back end on), 0.030221 m, x 1.5 + 5 mm (PERF.md).
ATE_BOUND_M = 0.05034
# The frame before which the constant-velocity prior is replaced by
# JOLT_PRIOR: 0.2 rad about the camera's y axis and 0.3 m sideways. Searched
# from there, the frame finds too few inliers; the fallback re-seeds from
# the reference keyframe and the last pose.
JOLT_FRAME = 40
JOLT_PRIOR = ((0.0, 0.2, 0.0), (0.3, 0.0, 0.0))

FAST_SHAPES = [(400, 640), (320, 512), (240, 384), (196, 314), (160, 256),
               (127, 203), (101, 161), (80, 128)]
KNN_SHAPES = [(64, 64, True), (300, 450, True), (512, 1024, True),
              (100, 200, False), (512, 512, True)]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn, n: int = 100, warm: int = 10) -> float:
    """Median device time of fn() in ms, from CUDA events around each call."""
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


def check_fast(dev, gen, rendered_levels):
    """Kernel 1 vs nms3x3(fast_scores(.)) on the card: every level shape at
    DETECT_MARGIN and 64x128 at margin 3, random and rendered images."""
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
    log(f"[smoke] kernel 1 bit-exact on {len(cases)} cases")
    x = torch.randint(0, 256, (2, 400, 640), generator=gen, dtype=torch.uint8)
    x = x.to(dev).float()
    ms = cuda_ms(lambda: cuda_fast.fast_scores_nms(x, DETECT_MARGIN))
    plain_ms = cuda_ms(lambda: cuda_fast.fast_scores_nms_plain(x, DETECT_MARGIN))
    return err, ms, plain_ms


def check_knn_pair(a, b, av, bv):
    from orbslam3lib_tpu_torch.ops import cuda_matcher, matcher
    got = cuda_matcher.knn_match_fused(a, b, av, bv)
    want = matcher.knn_match(a, b, av, bv)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("best", "d1", "d2")):
        if not torch.equal(g, w):
            raise AssertionError(f"knn_match_fused {name} differs at "
                                 f"{tuple(a.shape)}x{tuple(b.shape)}")
    return max(max_err(g, w) for g, w in zip(got, want))


def check_knn(dev, gen):
    """Kernel 2 vs the plain Hamming product + knn2 on the card."""
    from orbslam3lib_tpu_torch.ops import cuda_matcher, matcher
    err = 0.0
    for na, nb, masked in KNN_SHAPES:
        a = (torch.rand((na, 256), generator=gen) < 0.5).to(torch.int8).to(dev)
        b = (torch.rand((nb, 256), generator=gen) < 0.5).to(torch.int8).to(dev)
        av = (torch.rand(na, generator=gen) < 0.9).to(dev) if masked else None
        bv = (torch.rand(nb, generator=gen) < 0.9).to(dev) if masked else None
        err = max(err, check_knn_pair(a, b, av, bv))
    log(f"[smoke] kernel 2 bit-exact on {len(KNN_SHAPES)} random cases")
    a = (torch.rand((512, 256), generator=gen) < 0.5).to(torch.int8).to(dev)
    b = (torch.rand((512, 256), generator=gen) < 0.5).to(torch.int8).to(dev)
    av = (torch.rand(512, generator=gen) < 0.9).to(dev)
    bv = (torch.rand(512, generator=gen) < 0.9).to(dev)
    ms = cuda_ms(lambda: cuda_matcher.knn_match_fused(a, b, av, bv))
    plain_ms = cuda_ms(lambda: matcher.knn_match(a, b, av, bv))
    return err, ms, plain_ms


class StepTimer:
    """Wraps a back-end step: CUDA events around each call (read after the
    run, so timing adds no wait) and torch's sync debug mode, which warns
    at every point where the host would wait on the card."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []
        self.syncs = []

    def __call__(self, *args, **kwargs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                s.record()
                out = self.fn(*args, **kwargs)
                e.record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.syncs += [str(w.message) for w in caught
                       if "called a synchronizing" in str(w.message)]
        self.events.append((s, e))
        return out

    def ms(self):
        return [s.elapsed_time(e) for s, e in self.events]


def main() -> int:
    if not torch.cuda.is_available():
        log("[smoke] CUDA is not available: this smoke test needs one CUDA card")
        return 2
    from orbslam3lib_tpu_torch.device import card_line
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.io.synthetic import (orbit_pose_at,
                                                    orbit_tracking_config,
                                                    render_orbit_sequence)
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
    log(f"[smoke] built {', '.join(_cuda_lib.SOURCES)} with nvcc in {build_s:.2f} s")

    # -- 2. kernels vs their plain versions --------------------------------
    t0 = time.perf_counter()
    imgs, ts, rig = render_orbit_sequence(N_FRAMES)
    log(f"[smoke] rendered {N_FRAMES} stereo frames in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(0)
    rendered = pyramid.build_pyramid(torch.as_tensor(imgs[0], device=dev), 8)
    fast_err, fast_ms, fast_plain_ms = check_fast(dev, gen, rendered)
    knn_err, knn_ms, knn_plain_ms = check_knn(dev, gen)
    log(f"[smoke] fast_scores_nms (2x400x640): kernel {fast_ms:.4f} ms, "
        f"plain {fast_plain_ms:.4f} ms")
    log(f"[smoke] knn_match_fused (512x512): kernel {knn_ms:.4f} ms, "
        f"plain {knn_plain_ms:.4f} ms")

    cfg = orbit_tracking_config(rig)
    img0 = torch.as_tensor(imgs[0], device=dev)
    extract_ms = cuda_ms(lambda: extract_orb_stereo(
        img0, 17.0, max_kp=512, n_levels=8, return_canvas=True), n=30, warm=3)
    log(f"[smoke] extract_orb_stereo (2x400x640, 512 kp, 8 levels): "
        f"{extract_ms:.3f} ms per frame")

    # -- 3. the slice: frames in, poses out ---------------------------------
    mapper_t = StepTimer(ttr.mapper_step_fused)
    ba_t = StepTimer(ttr._local_ba)
    ttr.mapper_step_fused, ttr._local_ba = mapper_t, ba_t
    tracker = Tracker(cfg, sensor="stereo", device=dev)
    jolt = (lie.so3_exp(torch.tensor(JOLT_PRIOR[0], device=dev)),
            torch.tensor(JOLT_PRIOR[1], device=dev))
    torch.cuda.synchronize()
    cuda_fast.reset_count()
    cuda_matcher.reset_count()
    frame_ms, jolt_res = [], None
    for i in range(N_FRAMES):
        if i == JOLT_FRAME:
            tracker.vel = jolt
        t0 = time.perf_counter()
        res = tracker.process_frame(imgs[i], float(ts[i]))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i == JOLT_FRAME:
            jolt_res = res
    launches = {"fast_scores_nms": cuda_fast.launches,
                "knn_match_fused": cuda_matcher.launches}
    torch.cuda.synchronize()

    st = tracker.stats
    med, p90 = np.percentile(frame_ms, 50), np.percentile(frame_ms, 90)
    n_alive = int(tracker.map.kf_valid.sum())
    log(f"[smoke] slice: {N_FRAMES} frames, median {med:.2f} ms, p90 {p90:.2f} ms "
        f"per frame (first {frame_ms[0]:.1f} ms); KFs {st['n_kf']} created, "
        f"{n_alive} alive; landmarks {int(tracker.map.n_mp)}, track_fail "
        f"{st['track_fail']}, ref-KF fallbacks {st['ref_kf_fallbacks']} (jolted "
        f"frame {JOLT_FRAME}: {jolt_res}, {frame_ms[JOLT_FRAME]:.2f} ms); "
        f"mapping steps {st['n_mapping_steps']}, local BAs {st['n_local_ba']}; "
        f"launches {launches}")
    per_kf = {name: t.ms() for name, t in (("mapper_step_fused", mapper_t),
                                            ("map_window_ba", ba_t))}
    print("per-keyframe device ms (CUDA events): " + "; ".join(
        f"{name} median {np.median(v):.3f}, p90 {np.percentile(v, 90):.3f}, "
        f"max {np.max(v):.3f} over {len(v)}" for name, v in per_kf.items() if v))
    syncs = mapper_t.syncs + ba_t.syncs
    if syncs:
        log(f"[smoke] host syncs in the back end: {len(syncs)}; first: {syncs[:3]}")

    centers = tracker.trajectory_centers()
    t_traj = np.asarray([f[0] for f in tracker.trajectory])
    _, gt = orbit_pose_at(t_traj, period=24.0, radius=0.5)
    ate = ate_rmse(centers, gt) if len(centers) >= 3 else float("inf")
    log(f"[smoke] ATE {ate:.6f} m over {len(centers)} frames (bound {ATE_BOUND_M} m)")

    # kernel 2 on real descriptors: the last frame's against the last
    # keyframe's (after the counters were read)
    feats = extract_orb_stereo(
        torch.as_tensor(imgs[-1], device=dev), float(np.float32(tracker.threshold.t)),
        max_kp=cfg.orb.max_kp, n_levels=cfg.orb.n_levels)
    kf = tracker.last_kf_id
    knn_err = max(knn_err, check_knn_pair(
        feats.desc[0], tracker.map.kf_desc[kf], feats.valid[0],
        tracker.map.kf_feat_valid[kf] & (tracker.map.kf_mp[kf] >= 0)))
    log("[smoke] kernel 2 bit-exact on the last frame's descriptors vs the last keyframe's")

    checks = {
        "state OK": tracker.state == OK,
        "no track failure": st["track_fail"] == 0,
        ">= 10 keyframes": st["n_kf"] >= 10,
        "local mapping on every keyframe after the first":
            st["n_mapping_steps"] == len(mapper_t.events) == st["n_kf"] - 1,
        "local BA on every keyframe from the third on":
            st["n_local_ba"] == len(ba_t.events) == st["n_kf"] - 2,
        "no host sync in the back end": not syncs,
        "landmarks within max_mp": 0 < int(tracker.map.n_mp) <= cfg.map.max_mp,
        "jolted frame took the ref-KF fallback and tracked":
            st["ref_kf_fallbacks"] >= 1 and jolt_res["state"] == OK,
        "kernel 1 once per level per frame":
            launches["fast_scores_nms"] == cfg.orb.n_levels * N_FRAMES,
        "kernel 2 launched": launches["knn_match_fused"] >= 1,
        "finite poses": bool(np.isfinite(centers).all()) and len(centers) == N_FRAMES,
        "ATE within bound": ate <= ATE_BOUND_M,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        log(f"[smoke] FAILED: {failed}")
        return 1

    src = "orbslam3lib_tpu_torch/csrc/"
    kernels = {"kernels": [
        {"name": "fast_scores_nms", "route": "cuda", "source": src + "fast_nms.cu",
         "replaces": "orbslam3lib_tpu/ops/pallas_fast.py:92",
         "launches": launches["fast_scores_nms"], "max_abs_err": fast_err,
         "ms": fast_ms, "plain_ms": fast_plain_ms},
        {"name": "knn_match_fused", "route": "cuda", "source": src + "knn2.cu",
         "replaces": "orbslam3lib_tpu/ops/pallas_matcher.py:77",
         "launches": launches["knn_match_fused"], "max_abs_err": knn_err,
         "ms": knn_ms, "plain_ms": knn_plain_ms},
    ]}
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
