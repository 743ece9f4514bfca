#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`orbslam3lib_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build: compile the CUDA sources of `orbslam3lib_tpu_torch/csrc/` with
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
     H100's published peaks) goes beside its time. The pose solve's two
     kernels (`ops/cuda_pose.py`) on `torch_parity.pose_problem` rows at
     POSE_SHAPES (512, the orbit's; 1,200, EuRoC's; 77, less than a block)
     against the torch path on the same card inputs: an evaluation bit-equal
     (`torch.equal` on r, J, chi2 and behind), one step from it within
     POSE_STEP_TOL, and whole solves at the orbit's 2 x 2 and EuRoC's 4 x 10
     within POSE_SOLVE_TOL with one launch per evaluation and per step; each
     kernel timed at 512 and 1,200 rows as above, and a 4 x 10 solve's ATen
     operations and host ms on both paths (`solve` in the pose_eval row).
     The VI window's two kernels (`ops/cuda_vi.py`) on
     `torch_parity.vi_problem` windows of VI_SHAPES keyframes (EuRoC's 9,
     VIBA's 24) at 1,200 slots: H and g against the float64 oracle
     (`vi_ba._normal_equations_torch`) within VI_NE_TOL, whole windows
     against the torch path within VI_WINDOW_TOL with one launch per
     evaluation and per step, two runs bit-equal; each kernel timed at both
     sizes, solve_ex on the assembled H beside the step (`dense_solve`) and
     a window's ATen operations and host ms on both paths (`window`);
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
  7. P, production: bench.py's `full_slam` protocol (bench.py:329-440) on
     the port, over the first N_PRODUCTION frames of phase 3's orbit:
     `Tracker(cfg, "stereo", pipeline=16, chunk=4, async_mapping=True)` with
     `cfg.mapping.async_gba` (the pipelined tracker, the mapper thread, the
     global BA on its own thread); a populate of 240 frames with the mapper
     queue detached (mapping inline), a keyframe every 2nd frame and
     culling off, `finish()` and one `_compact_map()`; 16 warm frames; 3
     windows of 40 frames, each timed on the host's clock and ended by
     `_drain_pipeline()`. A line per window (ms per frame, failures,
     keyframes, loops) beside phase 3's synchronous median of the same
     call; the host ms of `process_frame` calls made while the mapper was
     busy and while it was idle. Checks: state OK and no failure in a
     window, at least one loop and one merged async GBA, no mapper or GBA
     error and every thread joined, kernel 1 once per extracted frame and
     kernel 2 at least once, the trajectory's ATE within the reference's
     bound (REF_PRODUCTION, tools/reference_smoke.py --phase production).
  8. M, multi-map: phase 3's pinhole frames with frames MULTIMAP_GREY
     flat grey (their stamps kept), through one synchronous
     `System(cfg, "stereo")` at bench.py's configuration with loop closing
     on: map A (frames 0-179, more than 10 keyframes) is lost on the grey
     frames, and the 5 s timeout archives it in the Atlas; map B
     initialises on frame 260; when the orbit comes back to A's start
     (frame ~345, 360 frames a turn) the map merger welds A into B through
     the Sim(3) it verified (the cross match is kernel 2). `save_atlas`
     right after the spawn (two maps) and after the merge; each file loads
     into a fresh System on the card. Checks against the reference's run
     of the same frames (REF_MULTIMAP, tools/reference_smoke.py --phase
     multimap): one map spawned, one merge, one map at the end, the merge
     frame and the merged keyframe count within +-2 of the reference's, the
     merged map's keyframe ATE (A's keyframes in B's world) and each map's
     trajectory ATE within x 1.5 + 5 mm, kernel 1 once per frame, kernel 2
     inside the merge, and every loaded array `torch.equal` to the saved
     one with the same `map_info`. Printed: the merge's stages in device ms
     (CUDA events: archive query, cross match, Sim(3), transform +
     merge_into, welding BA, BoW rebuild) and the peak device memory with
     two maps.
  9. O, monocular: the left images of phase 3's first N_MONO frames
     through `System(cfg, "mono").track_monocular` (two-view
     initialisation, then tracking without depth, loop closing on), with
     phase 3's wrong motion prior before frame MONO_JOLT_FRAME so that the
     TrackReferenceKeyFrame fallback launches kernel 2. Checks against the
     reference's run of the same frames (REF_MONO, tools/reference_smoke.py
     --phase mono --median-depth: the reference with its initial map scaled
     to median depth 1, as the port scales it): the initialisation frame
     within MONO_INIT_TOL (the card draws its own two-view hypotheses), the
     initial map's median depth 1, keyframes within +-2, no failure, the
     jolted frame recovered by the fallback, state OK, the Sim(3)-aligned
     ATE within x 1.5 + 5 mm, kernel 1 once per frame and kernel 2 at least
     once. Printed: the initialisation's stages in device ms and their host
     syncs per attempt (the batched SVDs).
 10. R, RGB-D: the left images of phase 3's first N_RGBD frames with the
     depth maps of `io.synthetic.orbit_depth_maps` through
     `System(cfg, "rgbd").track_rgbd` (the depth read at the keypoints on
     the card, then the stereo tracker), with the wrong motion prior before
     frame RGBD_JOLT_FRAME. Checks against REF_RGBD (tools/reference_smoke.py
     --phase rgbd): state OK, no failure, keyframes within +-2, the ATE
     within x 1.5 + 5 mm, kernel 1 once per frame, kernel 2 at least once,
     no host sync in the depth gather.
 11. I, stereo-inertial: the corridor of tests/test_slam_modes.py (seed 5,
     640x400), N_IMU frames at 15 FPS, with frames IMU_GREY flat grey
     (their stamps kept), through `System(cfg, "imu_stereo").track_stereo(
     pair, ts, imu=(gyro, acc, dts))` at bench.py's configuration with loop
     closing on; the IMU is `io.synthetic.corridor_imu_stream` (200 Hz,
     cfg.imu's noise, the constant biases IMU_BG / IMU_BA, one seeded
     generator). The tracker initialises the IMU, runs VIBA1 and VIBA2,
     dead-reckons over the grey frames (keyframes inserted while lost) and
     picks tracking up again; before frame IMU_JOLT_FRAME the IMU state's
     velocity is off by IMU_JOLT_V, so that frame takes the
     TrackReferenceKeyFrame fallback (kernel 2). Checks against the
     reference's run of the same frames and IMU (REF_IMU,
     tools/reference_smoke.py --phase imu): the initialisation frame within
     +-2, VIBA1 and VIBA2 run, the same failures (the grey frames), state OK
     at the end, keyframes within +-2, the ATEs (trajectory and keyframes)
     and the grey frames' largest error within x 1.5 + 5 mm, the bias
     estimates (the median of the keyframes' VI-BA biases since the
     initialisation) within 20% + 1e-3 and the last frame's inside the
     reference's last 30 frames' range, kernel 1 once per frame and kernel
     2 at least once, finite poses. Printed: ms per frame, host ms and launches
     per `feed_imu`, device ms and host syncs of the per-frame inertial
     solves, ms of each VI window, of the IMU initialisation and of
     VIBA1 / VIBA2, and the peak device memory.
 12. J, monocular-inertial: the seed-5 corridor driven at IMU_MONO_SPEED
     with a lateral sway of IMU_MONO_WIGGLE (`io.synthetic.corridor_pose_at`;
     at phase I's 0.8 m/s and 0.25 m the monocular scale cannot be observed
     and the reference never initialises), N_IMU_MONO left images of
     `io.synthetic.render_corridor_mono` (rendered in a sixth worker) and
     `corridor_imu_stream(speed=, wiggle=)` (phase I's noise and biases),
     through `System(cfg, "imu_mono").track_monocular(img, ts, imu=...)` at
     bench.py's configuration with loop closing on: the two-view
     initialisation, the inertial initialisation with the scale (an attempt
     whose scale is under 0.1 is dropped and retried on the next keyframe),
     VIBA1, VIBA2 and the scale refinements, as far as the reference reaches
     them; the run takes the TrackReferenceKeyFrame fallback (kernel 2) on
     its own, as the reference's does. Checks against the reference's run of the same frames and
     IMU with its initial map at median depth 1 as the port's
     (REF_IMU_MONO, tools/reference_smoke.py --phase imu_mono
     --median-depth): the map's initialisation frame within MONO_INIT_TOL,
     the IMU initialisation within +-2 keyframes, VIBA1 (and VIBA2 and the
     scale refinement where the reference reached them), the failures'
     outcome (no reset, no new map; which frames fail is chaotic in the
     inputs, and both lists are printed), keyframes within +-2, the
     SE(3)-aligned ATE of the frames from the IMU initialisation on within
     x 1.5 + 5 mm, the distance of the Sim(3) alignment's scale from 1
     within x 1.5 + 0.02, the keyframes' median biases finite and within
     IMU_MONO_BIAS_MAX (the reference's carry its scale error), kernel 1
     once per frame and kernel 2 at least once, finite poses. Printed
     beside the card's name and power limit: ms
     per frame, device ms of each initialisation attempt, of VIBA1 / VIBA2
     and of each scale refinement, device ms and peak memory of the VI
     windows, and the host syncs of the per-frame inertial solves.
 13. W, the fixed local-BA window: phase 3's first N_FIXED_WINDOW frames
     through `System.track_stereo` with `cfg.mapping.covis_ba_window`
     off (local BA over the last `window_size` keyframes and up to
     `n_fixed` anchors before them). Checks against the reference's run of
     the same frames (REF_FIXED_WINDOW, tools/reference_smoke.py --phase
     fixed_window): state OK, no failure, keyframes within +-2, every local
     BA from the third keyframe on over the fixed window, kernel 1 once per
     frame, the ATE within x 1.5 + 5 mm.
 14. N, the native BoW database: `native/bow.cpp` built with g++ here (a
     failed build fails the phase; there is no fallback to the dense
     database), then on phase 3's final map, over every valid keyframe:
     the native word ids equal the dense descent on the card, its query
     scores within NATIVE_SCORE_TOL of the dense database's and its top-3
     candidates equal; host ms per native query beside the dense query's
     device ms. Then the native loop probe (`LoopCloser.dispatch_probe`)
     keyframe by keyframe, each added to the database just before its
     probe, its packs consumed by `on_probe_result` on a copy of the map
     (kernel 2 in the verifications, where any).
 15. X, the sharded back end and front end on the one card (the sharded
     arithmetic, not an interconnect): phase 3's final map saved, then
     `global_bundle_adjust_dist` on it over DeviceMesh(["cuda:0"] * 2), * 4
     and a ProcessMesh of two spawned gloo ranks on cuda:0 (NCCL takes one
     rank a card), each within DIST_R_TOL / DIST_T_TOL of the plain
     `global_bundle_adjust` on the same map; ms per GBA per route and the
     bytes reduced per iteration. Then `make_sharded_frontend` over
     DeviceMesh(["cuda:0"] * 2) on N_SHARDED_FRAMES frames against
     `extract_orb_stereo` + `match_rectified_stereo` frame by frame:
     keypoints, levels, validity and descriptors equal, u_r and depth within
     SHARDED_DEPTH_TOL, kernel 1 once per shard.
  Phases 4-15 each reset the launch counters just before their frames and
  read them just after; each kernel must launch on each of phases 4-13,
  except the pose kernels on phase F, whose Kannala-Brandt camera keeps the
  torch path and must launch none, and the VI kernels, which launch on
  phases I and J (every VI window evaluation the kernels': the tracker's
  `vi_evals_fused` equals the launches, `vi_evals_torch` is 0) and on no
  other phase (counts in the kernels line, `launches_by_path`; N and X
  check their own launches). In phase 3 every pose evaluation is the
  kernel's (the tracker's `pose_evals_fused` equals the launches,
  `pose_evals_torch` is 0). The sequences and the depth maps
  render in six processes started before the card is used. Kernel 1 is
  also checked bit-exact and timed at batch 1 (one image's 8 levels, the
  mono and RGB-D frame: `batch1` in its row).

The last three lines of standard output are the card's name and power
limit (as nvidia-smi gives them), one JSON object with a row per kernel,
and the result line {"ok": true, "device": {...}}. Without a CUDA device it
exits non-zero and prints no result. Imports nothing of JAX. Reference
numbers: `tools/reference_smoke.py` (the JAX tracker on the CPU, same
frames and configurations).
"""
from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import re
import shutil
import sys
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# `torch_parity.pose_problem`, the pose kernels' rows (imports no JAX)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

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

# Phase P: bench.py's full_slam protocol (bench.py:39-42, 329-440)
N_POPULATE, N_WARM, N_WINDOWS, N_WINDOW = 240, 16, 3, 40
N_PRODUCTION = N_POPULATE + N_WARM + N_WINDOWS * N_WINDOW
# The JAX reference on the CPU, same protocol and frames, each chunk
# consumed right after its dispatch as on the card (tools/reference_smoke.py
# --phase production): 121 populate keyframes, the loop (12, 128) in the
# third window, one async GBA started and merged, one frame lost after the
# merge; ATE 0.081811 m on the trajectory, 0.051783 m on the keyframes.
# Bounds: x 1.5 + 5 mm (the keyframes' own, as the reference's keyframes
# are not worse than its trajectory).
REF_PRODUCTION = {"ate_m": 0.081811, "kf_ate_m": 0.051783}

# Phase M: the grey frames (first, last) of phase 3's orbit. The JAX
# reference on the CPU on these frames (tools/reference_smoke.py --phase
# multimap): map A of 14 keyframes archived at frame 256, map B initialised
# at frame 260, merged at frame 351 (B's 8 keyframes + A's 14 = 22), 24
# keyframes at the end, no loop; ATE 0.050335 m on the merged map's
# keyframes, 0.030220 m on A's frames, 0.022286 m on B's. Bounds: x 1.5 +
# 5 mm; the merge frame and keyframe count +-2 (the card's scatter order
# can flip a keyframe decision).
MULTIMAP_GREY = (180, 259)
REF_MULTIMAP = {"spawn_frame": 256, "merge_frame": 351, "n_kf_merged": 22,
                "kf_ate_merged_m": 0.050335, "ate_a_m": 0.030220, "ate_b_m": 0.022286}

# Phase O: the pinhole orbit's left images, frames 0..N_MONO-1 (the JAX
# reference's monocular tracker loses track at frame 130 and holds before
# it), the wrong prior of phase 3 before MONO_JOLT_FRAME. The reference on
# the CPU on these frames (tools/reference_smoke.py --phase mono
# --median-depth, its initial map scaled to median depth 1 as the port's):
# initialised at frame 22, 7 keyframes, no failure, one fallback, ATE
# 0.074012 m after a Sim(3) alignment (0.088103 m and 6 keyframes with its
# map unscaled).
REF_MONO = {"init_frame": 22, "n_kf": 7, "ate_sim3_m": 0.074012}
N_MONO = 130
MONO_JOLT_FRAME = 100
# the initialisation frame's tolerance: the port on the CPU with four seeds
# of its two-view draws initialised at frames 14, 14, 22 and 32
MONO_INIT_TOL = 12
# Phase R: the pinhole orbit's first N_RGBD left images and depth maps, the
# wrong prior before RGBD_JOLT_FRAME. The reference on the CPU
# (tools/reference_smoke.py --phase rgbd), the wrong prior before frame 150:
# 13 keyframes, no failure, ATE 0.040180 m (SE(3)-aligned).
REF_RGBD = {"n_kf": 13, "ate_m": 0.040180}
N_RGBD = 180
RGBD_JOLT_FRAME = 150

# Phase I: the corridor, its grey frames (first, count), the frame whose
# IMU velocity is off by IMU_JOLT_V (m/s; searched on the reference: 1.5
# and 3 m/s are absorbed by the two-stage search, 10 m/s sends the frame
# and the five after it, up to the next keyframe, through the fallback, 20
# m/s one frame but moves the bias estimates by 0.03 m/s^2), and the IMU's
# constant biases. The JAX reference on the CPU on these frames and IMU
# (tools/reference_smoke.py --phase imu): the IMU initialised at frame 23,
# VIBA1 at 103, VIBA2 at 250; 8 failures (the grey frames), fallbacks on
# frames 130-135 and 160-167, no relocalisation; 43 keyframes made; ATE
# 0.015090 m, keyframe ATE 0.009070 m, the grey frames' largest error
# 0.036231 m (SE(3)-aligned). The bias estimates: the median of the
# keyframes' VI-BA biases from the initialisation on (the IMU's biases are
# constant), and the range of one frame's estimate over the last 30 frames
# ((min, max) per component of bg then ba), which swings by +-0.1 m/s^2;
# the median is over 36 keyframes (the true biases: IMU_BG, IMU_BA).
N_IMU = 300
IMU_GREY = (160, 8)
IMU_JOLT_FRAME = 130
IMU_JOLT_V = (10.0, 0.0, 0.0)
IMU_BG = (0.002, -0.001, 0.0015)
IMU_BA = (0.02, -0.01, 0.015)
REF_IMU = {"imu_init_frame": 23, "viba1_frame": 103, "viba2_frame": 250, "track_fail": 8,
           "n_kf": 43, "ate_m": 0.015090, "kf_ate_m": 0.009070, "grey_err_m": 0.036231,
           "kf_bias_g": (0.002129, -0.001333, 0.001427),
           "kf_bias_a": (-0.048151, -0.008799, -0.024098),
           "bias_range": ((-0.002167, 0.010571), (-0.007692, 0.004262), (-0.003441, 0.005558),
                          (-0.145872, 0.110124), (-0.155021, 0.063183), (-0.093491, 0.085171))}

# Phase J: the seed-5 corridor driven at IMU_MONO_SPEED (m/s) with a
# lateral sway of IMU_MONO_WIGGLE (m), its end wall at IMU_MONO_Z1, the
# first N_IMU_MONO frames at 15 FPS (the reference loses its map from frame
# 269 on). The reference on the CPU on these frames and IMU
# (tools/reference_smoke.py --phase imu_mono --median-depth --frames 265):
# the map initialised at frame 1, the IMU at frame 24 (keyframe 7, scale
# 1.139 against ~3.2 true: the initialisation's scale is attenuated by the
# keyframes' noise, tools/imu_mono_scale.py), VIBA1 at 105, VIBA2 at 255, no
# scale refinement (it comes 25 s after the initialisation); 9 failures,
# no reset and no new map; 44 keyframes; ATE 7.515334 m after the
# initialisation (SE(3), the map 5.15 times too small) and the keyframes'
# median biases below. Which frames fail moves with any change of input:
# the same reference with the end wall at 60 m instead of 75 fails on 77
# frames (157-237) and spawns a new map; the port on the card over four
# seeds of its two-view draws fails on 4, 10, 22 and 80 frames
# (tools/imu_mono_seeds.py --device cuda --frames 265). So the phase holds
# the failures to the reference's outcome (no reset, no new map) and prints
# the frames. The biases are not held to the reference's: its accelerometer
# bias absorbs the scale error (0.37 m/s^2 in x where the IMU's is 0.02)
# and the card's seeds read 0.25-0.44 there; they are held finite and
# inside IMU_MONO_BIAS_MAX.
N_IMU_MONO = 265
IMU_MONO_SPEED, IMU_MONO_WIGGLE = 2.0, 1.2
IMU_MONO_Z1 = 75.0      # the corridor's end wall (m): 30 s at 2 m/s and 15 m beyond
REF_IMU_MONO = {"map_init_frame": 1, "imu_init_frame": 24, "imu_init_kf": 7, "init_scale": 1.139004,
                "viba1_frame": 105, "viba2_frame": 255, "refinements": [],
                "fail_frames": [68, 76, 78, 79, 81, 198, 203, 214, 216], "n_resets": 0,
                "n_new_maps": 0, "n_kf": 44, "ate_post_init_m": 7.515334, "sim3_scale": 5.153658,
                "kf_bias_g": (0.003212, -0.001371, 0.002201),
                "kf_bias_a": (0.366441, -0.041664, 0.101376)}
# |bg| (rad/s) and |ba| (m/s^2) per axis: a diverged bias estimate, not a
# band around the reference's
IMU_MONO_BIAS_MAX = (0.05, 1.0)

# Phase W: the fixed local-BA window on the first N_FIXED_WINDOW pinhole
# frames; the reference's run (tools/reference_smoke.py --phase
# fixed_window): 12 keyframes, no failure, ATE 0.025115 m.
N_FIXED_WINDOW = 150
REF_FIXED_WINDOW = {"n_kf": 12, "ate_m": 0.025115}
# Phase N: native scores against the dense database's on the card.
NATIVE_SCORE_TOL = 1e-5
# Phase X: the sharded global BA against the plain one (the reference's
# tolerances between its two solvers, tests/test_dist_ba.py), its LM
# schedule, and the sharded front end's frames and depth tolerance.
DIST_R_TOL, DIST_T_TOL = 2e-4, 2e-3
GBA_ITERS, GBA_CHUNK = 10, 5
N_SHARDED_FRAMES = 8
SHARDED_DEPTH_TOL = 1e-4
GLOO_TIMEOUT_S = 300

FAST_SHAPES = [(400, 640), (320, 512), (240, 384), (196, 314), (160, 256),
               (127, 203), (101, 161), (80, 128)]
# level lists whose widths are not multiples of 4 (kernel 1 in one launch)
ODD_SHAPES = [(127, 203), (101, 161), (196, 314), (37, 61), (5, 7), (1, 1)]
KNN_SHAPES = [(64, 64, True), (300, 450, True), (512, 1024, True),
              (100, 200, False), (512, 512, True), (1, 1, True),
              (33, 3000, True), (3, 16500, True)]
# the pose solve's rows, and the largest |R| / |t| gap to the torch path of
# one step and of a whole solve
POSE_SHAPES = (512, 1200, 77)
POSE_SCHEDULES = ((2, 2), (4, 10))
POSE_STEP_TOL, POSE_SOLVE_TOL = 1e-6, 1e-5
# bytes a row each pose kernel reads and writes: the evaluation reads
# p_world, uv, inv_sigma2, u_right, is_stereo (29) and writes r, J, chi2,
# behind (89); the step reads r, J, chi2, behind, inv_sigma2, delta,
# inlier, valid (105). Their operations (~100 f32 a row) bound far lower.
POSE_EVAL_BYTES, POSE_STEP_BYTES = 118, 105
# the VI window's kernels: EuRoC's window (8 + 1 keyframes) and VIBA's 24, at
# EuRoC's 1,200 slots and stereo (bf of a 0.11 m baseline at fx 300); the
# largest gap of H and g to the float64 oracle over their Cauchy-Schwarz
# scales, and of a whole window (VI_ITERS) to the torch path: poses, t,
# velocities, biases (test_torch_cuda's bounds)
VI_SHAPES, VI_F, VI_BF, VI_ITERS = (9, 24), 1200, 33.0, 10
VI_NE_TOL = 2e-5
VI_WINDOW_TOL = (1e-4, 1e-4, 1e-3, 1e-4, 1e-4)
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


def check_fast(dev, gen, rendered_levels, rendered_image_levels):
    """Kernel 1 vs nms3x3(fast_scores(.)) on the card: every level shape at
    DETECT_MARGIN and 64x128 at margin 3, random and rendered images, one
    level per launch; then every level of a list in one launch: the
    rendered frame's (both eyes), its left image's alone (batch 1, the
    mono and RGB-D frame), random ones at every FAST_SHAPES entry, and
    levels whose widths are not multiples of 4."""
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
        "rendered image (batch 1)": list(rendered_image_levels),
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


def reset_launches() -> None:
    """Zero every kernel's launch counter."""
    from orbslam3lib_tpu_torch.ops import cuda_fast, cuda_matcher, cuda_pose, cuda_vi
    for mod in (cuda_fast, cuda_matcher, cuda_pose, cuda_vi):
        mod.reset_count()


def launch_counts() -> dict:
    """Each kernel's launches since the last `reset_launches()`."""
    from orbslam3lib_tpu_torch.ops import cuda_fast, cuda_matcher, cuda_pose, cuda_vi
    return {"fast_scores_nms": cuda_fast.launches, "knn_match_fused": cuda_matcher.launches,
            "pose_eval": cuda_pose.eval_launches, "pose_step": cuda_pose.step_launches,
            "vi_eval": cuda_vi.eval_launches, "vi_step": cuda_vi.step_launches}


def pose_inputs(dev, n: int, seed: int):
    """`torch_parity.pose_problem`'s n rows on the card: (PoseObs, R0, t0,
    [fx, fy, cx, cy])."""
    from orbslam3lib_tpu_torch.tracking import pose_opt
    from torch_parity import POSE_CAM, pose_problem
    obs, _, (R0, t0) = pose_problem(n, seed)
    o = pose_opt.PoseObs(**{k: torch.from_numpy(v).to(dev) for k, v in obs.items()})
    return (o, *(torch.from_numpy(x).to(dev) for x in (R0, t0, POSE_CAM)))


def pose_step_args(o):
    """The rest of a first step's arguments: inv_sigma2, Huber delta, every
    row an inlier, valid, the damping."""
    from orbslam3lib_tpu_torch.utils.robust import DELTA_MONO, DELTA_STEREO
    return (o.inv_sigma2, torch.where(o.is_stereo, DELTA_STEREO, DELTA_MONO),
            torch.ones_like(o.inv_sigma2), o.valid.float(), 1e-3)


@contextlib.contextmanager
def torch_pose_path():
    """Inside, the pose solve takes its torch path on the card too."""
    from orbslam3lib_tpu_torch.tracking import pose_opt
    fused = pose_opt._fused
    pose_opt._fused = lambda R, cam_model: False
    try:
        yield
    finally:
        pose_opt._fused = fused


def check_pose(dev):
    """The pose kernels vs the torch path on the same card inputs: each
    evaluation bit-equal, one step and whole solves within their limits,
    one launch per evaluation and per step. Returns (step gap, solve gap)."""
    from orbslam3lib_tpu_torch.ops import cuda_pose
    from orbslam3lib_tpu_torch.tracking import pose_opt
    from orbslam3lib_tpu_torch.utils import cameras
    from torch_parity import POSE_BF
    step_gap = solve_gap = 0.0
    for n in POSE_SHAPES:
        o, R0, t0, cam = pose_inputs(dev, n, n)
        got = cuda_pose.pose_eval(R0, t0, o, cam, POSE_BF)
        want = pose_opt._residuals_jacobians_torch(R0, t0, o, cameras.PINHOLE, cam, POSE_BF)
        for name, g, w in zip(("r", "J", "chi2", "behind"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"pose_eval {name} differs at N={n} by {max_err(g, w)}")
        R1, t1 = cuda_pose.pose_step(R0, t0, *got, *pose_step_args(o))
        R2, t2 = pose_opt._step_torch(R0, t0, *want, *pose_step_args(o))
        step_gap = max(step_gap, max_err(R1, R2), max_err(t1, t2))
        for rounds, iters in POSE_SCHEDULES:
            before = launch_counts()
            Rk, tk, _, _ = pose_opt.pose_optimization(R0, t0, o, cam, bf=POSE_BF,
                                                      n_rounds=rounds, iters_per_round=iters)
            made = [launch_counts()[k] - before[k] for k in ("pose_eval", "pose_step")]
            if made != [rounds * (iters + 1), rounds * iters]:
                raise AssertionError(f"a {rounds} x {iters} solve at N={n} made {made} launches")
            with torch_pose_path():
                Rt, tt, _, _ = pose_opt.pose_optimization(R0, t0, o, cam, bf=POSE_BF,
                                                          n_rounds=rounds, iters_per_round=iters)
            solve_gap = max(solve_gap, max_err(Rk, Rt), max_err(tk, tt))
    if step_gap > POSE_STEP_TOL or solve_gap > POSE_SOLVE_TOL:
        raise AssertionError(f"pose kernels off the torch path: step {step_gap}, "
                             f"solve {solve_gap}")
    log(f"[smoke] pose_eval bit-equal at N = {POSE_SHAPES}; a step within {step_gap:.3g}, "
        f"solves {POSE_SCHEDULES} within {solve_gap:.3g} of the torch path")
    return step_gap, solve_gap


def time_pose(dev, n: int):
    """Both pose kernels at n rows, as time_knn; `plain_ms` is the torch
    path's evaluation and step."""
    from orbslam3lib_tpu_torch.device import device_ms_per_launch
    from orbslam3lib_tpu_torch.ops import cuda_pose
    from orbslam3lib_tpu_torch.tracking import pose_opt
    from orbslam3lib_tpu_torch.utils import cameras
    from torch_parity import POSE_BF
    o, R0, t0, cam = pose_inputs(dev, n, n)
    ev, rest = cuda_pose.pose_eval(R0, t0, o, cam, POSE_BF), pose_step_args(o)
    runs = {"pose_eval": (lambda: cuda_pose.pose_eval(R0, t0, o, cam, POSE_BF),
                          lambda: pose_opt._residuals_jacobians_torch(
                              R0, t0, o, cameras.PINHOLE, cam, POSE_BF), POSE_EVAL_BYTES),
            "pose_step": (lambda: cuda_pose.pose_step(R0, t0, *ev, *rest),
                          lambda: pose_opt._step_torch(R0, t0, *ev, *rest), POSE_STEP_BYTES)}
    out = {}
    for name, (fn, plain, row_bytes) in runs.items():
        t = {"ms": device_ms_per_launch(fn, N_TIMED, graph=True),
             "loop_ms": device_ms_per_launch(fn, N_TIMED),
             "call_ms": call_ms(fn),
             "plain_ms": device_ms_per_launch(plain, 50, 5)}
        t["bound_ms"], t["bound_by"] = bound(row_bytes * n, 0)
        out[name] = t
    return out


class CountOps(TorchDispatchMode):
    """Counts the ATen operations dispatched inside."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def pose_solve_cost(dev, n: int = 1200, rounds: int = 4, iters: int = 10):
    """A rounds x iters solve of n rows on the kernels and on the torch
    path: ATen operations dispatched and host ms (synchronised after each
    of 20)."""
    from orbslam3lib_tpu_torch.tracking import pose_opt
    from torch_parity import POSE_BF
    o, R0, t0, cam = pose_inputs(dev, n, n)

    def solve():
        return pose_opt.pose_optimization(R0, t0, o, cam, bf=POSE_BF, n_rounds=rounds,
                                          iters_per_round=iters)

    out = {"n": n, "schedule": [rounds, iters]}
    for path, where in (("kernels", contextlib.nullcontext), ("torch", torch_pose_path)):
        with where():
            with CountOps() as c:
                solve()
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            for _ in range(20):
                solve()
                torch.cuda.synchronize()
            out[path] = {"aten_ops": c.n, "host_ms": (time.perf_counter() - t0_) / 20 * 1e3}
    return out


def vi_inputs(dev, C: int):
    """`torch_parity.vi_problem`'s window of C keyframes and VI_F slots on
    the card: (map, local_inertial_ba's keywords, its vi_ba.Window)."""
    from orbslam3lib_tpu_torch.mapping import vi_ba
    from torch_parity import vi_problem
    m, kw = vi_problem(C=C, F=VI_F, n_pts=2 * VI_F, bf=VI_BF, device=dev, no_imu=(3,))
    return m, kw, vi_ba.window_problem(m, **kw)


def vi_x(C: int, dev):
    """A seeded x of poses ~0.02, velocities ~0.05, biases ~1e-3."""
    rng = np.random.default_rng(C)
    x = rng.normal(size=(C, 15)) * np.array([0.02] * 6 + [0.05] * 3 + [1e-3] * 6)
    return torch.from_numpy(x.reshape(-1).astype(np.float32)).to(dev)


@contextlib.contextmanager
def torch_vi_path():
    """Inside, the VI window takes its torch path on the card too."""
    from orbslam3lib_tpu_torch.mapping import vi_ba
    fused = vi_ba._fused
    vi_ba._fused = lambda *a: False
    try:
        yield
    finally:
        vi_ba._fused = fused


def check_vi(dev):
    """The VI kernels on the card: H and g against `_normal_equations_torch`
    in float64 on the same inputs (each entry over its Cauchy-Schwarz
    scale), whole windows against the torch path (poses, velocities,
    biases), two runs bit-equal, one launch per evaluation and per step.
    Returns (normal equations gap, window gap)."""
    from orbslam3lib_tpu_torch.mapping import vi_ba
    from orbslam3lib_tpu_torch.ops import cuda_vi
    from torch_parity import vi_window_as
    ne_gap = win_gap = 0.0
    for C in VI_SHAPES:
        m, kw, w = vi_inputs(dev, C)
        x = vi_x(C, dev)
        H, g = cuda_vi.normal_equations(cuda_vi.pack(w), x)
        H_o, g_o = vi_ba._normal_equations_torch(vi_window_as(w, torch.float64), x.double())
        d = torch.sqrt(torch.diagonal(H_o))
        ne_gap = max(ne_gap, float(((H - H_o).abs() / (d[:, None] * d[None, :])).max()),
                     float(((g - g_o).abs() / (d * (g_o / d).abs().max())).max()))
        before = launch_counts()
        got = vi_ba.local_inertial_ba(m, n_iters=VI_ITERS, **kw)
        made = [launch_counts()[k] - before[k] for k in ("vi_eval", "vi_step")]
        if made != [VI_ITERS, VI_ITERS]:
            raise AssertionError(f"a window of {C} made {made} launches")
        again = vi_ba.local_inertial_ba(m, n_iters=VI_ITERS, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"two runs of a window of {C} differ")
        with torch_vi_path():
            want = vi_ba.local_inertial_ba(m, n_iters=VI_ITERS, **kw)
        win_gap = max(win_gap, *(max_err(a, b) / tol for a, b, tol in
                                 zip(got, want, VI_WINDOW_TOL)))
    if ne_gap > VI_NE_TOL or win_gap > 1.0:
        raise AssertionError(f"VI kernels off their oracle or the torch path: normal "
                             f"equations {ne_gap}, windows {win_gap} of their limits")
    log(f"[smoke] vi_eval + vi_step: H and g within {ne_gap:.3g} of the float64 oracle, "
        f"windows of {VI_SHAPES} within {win_gap:.3g} of their limits from the torch path, "
        f"repeats bit-equal")
    return ne_gap, win_gap


def vi_bytes(p, kernel: str) -> int:
    """Bytes each VI kernel reads and writes once: vi_eval the packed
    window and x in, the slots out; vi_step the slots, the keyframes and x
    in, x and the states out."""
    size = lambda t: t.numel() * t.element_size()   # noqa: E731
    part = 8 * p.part_size
    if kernel == "vi_eval":
        return size(p.kf) + size(p.gap) + size(p.obs) + size(p.cst) + 4 * 15 * p.C + part
    return part + size(p.kf) + size(p.cst) + 4 * 15 * p.C + 4 * (15 + 21) * p.C


def time_vi(dev, C: int):
    """Both VI kernels at C keyframes, as time_pose; `plain_ms` is the
    torch path's evaluation (forward-mode Jacobian, J^T J, J^T r) and
    step (solve_ex); `oracle_ms` the plain analytic version's evaluation;
    `dense_solve` solve_ex on the assembled H, the alternative to the
    in-kernel block-tridiagonal Cholesky."""
    from orbslam3lib_tpu_torch.device import device_ms_per_launch
    from orbslam3lib_tpu_torch.mapping import vi_ba
    from orbslam3lib_tpu_torch.ops import cuda_vi
    from orbslam3lib_tpu_torch.tracking.inertial_opt import jacobian_fwd
    _, _, w = vi_inputs(dev, C)
    p, x = cuda_vi.pack(w), vi_x(C, dev)
    part = cuda_vi.vi_eval(p, x)
    H, g = cuda_vi.normal_equations(p, x)
    H32, g32 = H.float(), g.float()
    eye = torch.eye(15 * C, device=dev)

    def plain_eval():
        r, J, _ = jacobian_fwd(lambda y: vi_ba._residuals(w, y), x)
        return J.T @ J + 1e-5 * eye, J.T @ r

    runs = {"vi_eval": (lambda: cuda_vi.vi_eval(p, x), plain_eval),
            "vi_step": (lambda: cuda_vi.vi_step(p, part, x),
                        lambda: x - torch.linalg.solve_ex(H32, g32)[0])}
    out = {}
    for name, (fn, plain) in runs.items():
        t = {"ms": device_ms_per_launch(fn, N_TIMED, graph=True),
             "loop_ms": device_ms_per_launch(fn, N_TIMED),
             "call_ms": call_ms(fn),
             "plain_ms": device_ms_per_launch(plain, 5, 1)}
        t["bound_ms"], t["bound_by"] = bound(vi_bytes(p, name), 0)
        out[name] = t
    out["vi_eval"]["oracle_ms"] = device_ms_per_launch(
        lambda: vi_ba._normal_equations_torch(w, x), 5, 1)
    out["vi_step"]["dense_solve"] = {
        "ms": device_ms_per_launch(lambda: torch.linalg.solve_ex(H32, g32), N_TIMED, graph=True),
        "call_ms": call_ms(lambda: torch.linalg.solve_ex(H32, g32))}
    return out


def vi_window_cost(dev, C: int):
    """A whole window (set-up and VI_ITERS iterations) of C keyframes on
    the kernels and on the torch path: ATen operations dispatched and host
    ms (synchronised after each of 10; 2 on the torch path)."""
    from orbslam3lib_tpu_torch.mapping import vi_ba
    m, kw, _ = vi_inputs(dev, C)
    out = {"C": C, "iters": VI_ITERS}
    for path, where, n in (("kernels", contextlib.nullcontext, 10), ("torch", torch_vi_path, 2)):
        with where():
            with CountOps() as c:
                vi_ba.local_inertial_ba(m, n_iters=VI_ITERS, **kw)
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            for _ in range(n):
                vi_ba.local_inertial_ba(m, n_iters=VI_ITERS, **kw)
                torch.cuda.synchronize()
            out[path] = {"aten_ops": c.n, "host_ms": (time.perf_counter() - t0_) / n * 1e3}
    return out


def ptxas_report(log_text: str):
    """Per kernel (demangled-ish name): registers, shared memory bytes and
    spill stores/loads, from nvcc -Xptxas -v."""
    out, name, entry, own = {}, None, None, False
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            name = next((k for k in ("fast_nms_levels_kernel", "knn2_kernel",
                                     "pose_eval_kernel", "pose_step_kernel",
                                     "vi_eval_kernel", "vi_step_kernel")
                         if k in entry), entry)
            out[name] = {}
            continue
        if name is None:
            continue
        # the spill line that follows a callee's properties (a non-inlined
        # library routine) is not the kernel's
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            own = m.group(1) == entry
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and own:
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
    from orbslam3lib_tpu_torch.system import System
    sys_ = System(cfg, "stereo", device=dev)
    if setup is not None:
        setup(sys_)
    torch.cuda.synchronize()
    reset_launches()
    results, frame_ms = [], []
    for img, stamp in frames:
        t0 = time.perf_counter()
        results.append(sys_.track_stereo(img, stamp))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    sys_.shutdown()
    return sys_, results, frame_ms, launches


def trajectory_ate(tracker, ts, with_scale: bool = False) -> float:
    """The trajectory's ATE against the analytic orbit; `with_scale` aligns
    by a Sim(3) (a monocular map has no metric scale)."""
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at
    c = tracker.trajectory_centers()
    t = np.asarray([f[0] for f in tracker.trajectory])
    return ate_rmse(c, orbit_pose_at(t, period=24.0, radius=0.5)[1], with_scale=with_scale) \
        if len(c) >= 3 else float("inf")


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


def phase_production(dev, imgs, ts, rig, sync_median_ms):
    """Phase P: bench.py's full_slam protocol on the port."""
    from orbslam3lib_tpu_torch.io.synthetic import orbit_tracking_config
    from orbslam3lib_tpu_torch.tracking.tracker import OK, Tracker
    cfg = orbit_tracking_config(rig)
    cfg.mapping.async_gba = True
    tr = Tracker(cfg, "stereo", device=dev, pipeline=16, chunk=4, async_mapping=True)
    mapper = tr._mapper_thread
    # events by frame id: the frames lost, the loops and the GBA merges
    events = []
    consume, probes, after_merge = tr._consume_record, tr._consume_probes, tr._after_merge

    def consume_logged(rec, c, v, prev_pose):
        if int(v[1]) < cfg.tracker.min_inliers:
            events.append(("lost", rec.fids[c], int(v[1])))
        return consume(rec, c, v, prev_pose)

    def probes_logged(probe_list):
        n = tr.stats["n_loops"]
        out = probes(probe_list)
        if tr.stats["n_loops"] > n:
            events.append(("loop", tr.frame_id, list(tr.loop_closer.loop_edges[-1])))
        return out

    def merge_logged(*a):
        events.append(("gba merged", tr.frame_id, tr.last_kf_id))
        return after_merge(*a)

    # the lag regime: chunks in flight at each non-draining finalize, and
    # how many of them it consumed
    in_flight = []
    finalize = tr._finalize_impl

    def finalize_logged(drain):
        before = len(tr._pending)
        finalize(drain)
        if not drain and before:
            in_flight.append((before, before - len(tr._pending)))

    tr._consume_record, tr._consume_probes, tr._after_merge, tr._finalize_impl = \
        consume_logged, probes_logged, merge_logged, finalize_logged
    frames = [(imgs[i], float(ts[i])) for i in range(N_PRODUCTION)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    # populate: dense keyframes, mapping inline (the queue detached), as bench
    kf_ratio = cfg.tracker.kf_ref_ratio
    cfg.tracker.kf_ref_ratio = 10.0
    cfg.tracker.min_frames_between_kf = 2
    cfg.tracker.max_frames_between_kf = 2
    cfg.mapping.kf_culling = False
    queue_save, tr._map_queue = tr._map_queue, None
    for img, stamp in frames[:N_POPULATE]:
        tr.process_frame(img, stamp)
    tr.finish()
    tr._map_queue = queue_save
    populate = (int(tr.map.n_kf), int(tr.map.mp_valid.sum()), tr.stats["track_fail"],
                time.perf_counter() - t0)
    cfg.tracker.kf_ref_ratio = kf_ratio
    cfg.tracker.min_frames_between_kf = 3
    cfg.tracker.max_frames_between_kf = 15
    cfg.mapping.kf_culling = True
    tr._compact_map()
    i = N_POPULATE
    for img, stamp in frames[i:i + N_WARM]:
        tr.process_frame(img, stamp)
    i += N_WARM
    tr._drain_pipeline()
    windows, calls = [], {"busy": [], "idle": []}
    for _ in range(N_WINDOWS):
        fails = tr.stats["track_fail"]
        tw = time.perf_counter()
        for img, stamp in frames[i:i + N_WINDOW]:
            busy = tr._map_queue.unfinished_tasks > 0
            tc = time.perf_counter()
            tr.process_frame(img, stamp)
            calls["busy" if busy else "idle"].append((time.perf_counter() - tc) * 1e3)
        i += N_WINDOW
        tr._drain_pipeline()
        windows.append(((time.perf_counter() - tw) / N_WINDOW * 1e3,
                        tr.stats["track_fail"] - fails, int(tr.map.n_kf), tr.stats["n_loops"]))
    tr.finish()
    torch.cuda.synchronize()
    launches = launch_counts()
    ate = trajectory_ate(tr, ts)
    kf_ate_m, _ = kf_ate(tr.map, float(ts[0]))
    st = dict(tr.stats)
    state = tr.state
    tr.shutdown_mapping()
    joined = tr._mapper_thread is None and not mapper.is_alive() and tr._gba_thread is None
    for n, (ms_, f, k, lp) in enumerate(windows):
        print(f"P window {n}: {ms_:.2f} ms per frame (host clock, drained), failures {f}, "
              f"keyframes {k}, loops {lp}; phase 3 synchronous median {sync_median_ms:.2f} ms "
              f"(same call)")
    for name, v in calls.items():
        log(f"[smoke] P process_frame calls with the mapper {name}: {len(v)}, median "
            f"{np.median(v) if v else float('nan'):.2f} ms, p90 "
            f"{np.percentile(v, 90) if v else float('nan'):.2f} ms (host)")
    ref = REF_PRODUCTION
    print(f"P production: populate {populate[0]} KFs, {populate[1]} live landmarks, "
          f"{populate[2]} failures, {populate[3]:.1f} s; ATE {ate:.6f} m (reference "
          f"{ref['ate_m']}), keyframe ATE {kf_ate_m:.6f} m (reference {ref['kf_ate_m']}); "
          f"loops {st['n_loops']} {tr.loop_closer.loop_edges}; async GBA started "
          f"{st['n_gba_started']}, merged {st['n_gba_merged']}, aborted "
          f"{st['n_gba_aborted']}; mapper errors {st['mapper_errors']}, GBA errors "
          f"{st['gba_errors']}; frames skipped {st['frames_skipped']}; launches {launches}")
    log(f"[smoke] P events (kind, frame id when seen, detail): {events}")
    fl = np.asarray(in_flight or [(0, 0)], np.float64)
    log(f"[smoke] P chunks in flight at a finalize: mean {fl[:, 0].mean():.2f}, max "
        f"{int(fl[:, 0].max())}; consumed per finalize: mean {fl[:, 1].mean():.2f}; "
        f"finalizes that consumed nothing: {int((fl[:, 1] == 0).sum())} of {len(fl)}")
    for err in tr.errors:
        log(err)
    # the reference's keyframes are worse than its trajectory (fault 1: its
    # GBA never merges): the port's keyframes are held to the trajectory bound
    kf_bound = ate_within(kf_ate_m, ref["ate_m"]) if ref["kf_ate_m"] is None or \
        ref["kf_ate_m"] > ref["ate_m"] else ate_within(kf_ate_m, ref["kf_ate_m"])
    checks = {
        "P: state OK, no failure in a window":
            state == OK and all(w[1] == 0 for w in windows),
        "P: at least one loop": st["n_loops"] >= 1,
        "P: at least one async GBA merged": st["n_gba_merged"] >= 1,
        "P: no mapper or GBA error": st["mapper_errors"] == 0 and st["gba_errors"] == 0,
        "P: every thread joined": joined,
        "P: kernel 1 once per extracted frame":
            launches["fast_scores_nms"] == N_PRODUCTION - st["frames_skipped"],
        "P: kernel 2 launched": launches["knn_match_fused"] >= 1,
        "P: ATE within the reference's bound": ate_within(ate, ref["ate_m"]),
        "P: keyframe ATE within its bound": kf_bound,
    }
    return checks, launches


def phase_multimap(dev, imgs, ts, rig):
    """Phase M: a lost map archived in the Atlas, merged back on a revisit,
    and the atlas saved and loaded on the card."""
    from orbslam3lib_tpu_torch.io.synthetic import orbit_tracking_config
    from orbslam3lib_tpu_torch.mapping import loop_closing as lc_mod
    from orbslam3lib_tpu_torch.mapping import sim3 as sim3_mod
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.models.atlas import Atlas
    from orbslam3lib_tpu_torch.ops import cuda_matcher
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking.tracker import Tracker
    g0, g1 = MULTIMAP_GREY
    grey = np.full_like(imgs[0], 128)
    frames = [(grey if g0 <= i <= g1 else imgs[i], float(ts[i])) for i in range(N_FRAMES)]
    sys_ = System(orbit_tracking_config(rig), "stereo", device=dev)
    tr = sys_.tracker

    # the merge's stages, timed inside MapMerger.on_keyframe (the Sim(3)
    # functions serve loop verification too); the BoW rebuild follows a merge
    inside = [False]
    patched = [(lc_mod.MapMerger, "best_hits", "archive query"),
               (lc_mod, "match_kf_landmarks_cross", "cross match"),
               (sim3_mod, "sim3_ransac", "sim3_ransac"),
               (sim3_mod, "optimize_sim3", "optimize_sim3"),
               (Atlas, "merge", "transform + merge_into"),
               (lc_mod.MapMerger, "_welding_ba", "welding BA"),
               (Tracker, "_rebuild_place_rec", "BoW rebuild")]
    timers = {name: StepTimer(getattr(o, n)) for o, n, name in patched}

    def gated(name):
        t = timers[name]
        return lambda *a, **k: t(*a, **k) if inside[0] else t.fn(*a, **k)

    on_kf = lc_mod.MapMerger.on_keyframe
    merge_launches = []

    def on_keyframe(self, *a, **k):
        inside[0] = True
        n0 = cuda_matcher.launches
        try:
            done = on_kf(self, *a, **k)
        finally:
            inside[0] = False
        if done:
            merge_launches.append(cuda_matcher.launches - n0)
        return done

    ev = {"spawn": None, "merge": None}
    real_merge = timers["transform + merge_into"]

    def atlas_merge(self, src_idx, *a):
        ev["merge"] = {"n_kf_b_before": int(self.current_map.n_kf),
                       "n_kf_a_valid": int(self.maps[src_idx].kf_valid.sum())}
        return real_merge(self, src_idx, *a)

    rebuild = timers["BoW rebuild"]
    wrappers = {"transform + merge_into": atlas_merge,
                "BoW rebuild": lambda *a, **k: rebuild(*a, **k)}
    saved = [(o, n, getattr(o, n)) for o, n, _ in patched] + \
        [(lc_mod.MapMerger, "on_keyframe", on_kf)]
    try:
        for o, n, name in patched:
            setattr(o, n, wrappers.get(name) or gated(name))
        lc_mod.MapMerger.on_keyframe = on_keyframe
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        states, poses, frame_ms, snaps, peak = [], [], [], {}, {}
        origin_a = None
        for i, (img, stamp) in enumerate(frames):
            if ev["spawn"] is None:
                origin_a = tr._ts_origin
            t0 = time.perf_counter()
            n_traj = len(tr.trajectory)
            res = sys_.track_stereo(img, stamp)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            states.append(int(res["state"]))
            poses.append(tr.trajectory[-1] if len(tr.trajectory) > n_traj else None)
            st = tr.stats
            for key, done in (("spawn", st["n_new_maps"] >= 1),
                              ("merge", st["n_map_merges"] >= 1)):
                if done and key not in snaps:
                    peak[key] = torch.cuda.max_memory_allocated()
                    if key == "spawn":
                        ev["spawn"] = {"frame": i, "n_kf_a": int(tr.atlas.maps[0].n_kf)}
                    else:
                        ev["merge"].update(frame=i, n_kf_after=int(tr.map.n_kf))
                    # right after the event: the file, and the arrays it must hold
                    path = os.path.join(tempfile.mkdtemp(), f"atlas_{key}.npz")
                    sys_.save_atlas(path)
                    snaps[key] = (path, [{k: v.copy() for k, v in ms.to_numpy(m).items()}
                                         for m in tr.atlas.maps], sys_.map_info(), i)
        launches = launch_counts()
        torch.cuda.synchronize()
    finally:
        for o, n, f in saved:
            setattr(o, n, f)
    st = sys_.get_stats()
    info_end = sys_.map_info()
    sys_.shutdown()
    map_bytes = sum(getattr(tr.map, k).numel() * getattr(tr.map, k).element_size()
                    for k in ms.FIELDS)
    ok_ev = ev["spawn"] is not None and ev["merge"] is not None and "frame" in ev["merge"]
    kf_ate_m = ate_a = ate_b = float("inf")
    if ok_ev:
        # the reference's numbers come from the same function
        from orbslam3lib_tpu_torch.evaluation import multimap_report
        nb = ev["merge"]["n_kf_b_before"]
        origins = [(0, tr._ts_origin), (nb, origin_a),
                   (nb + ev["merge"]["n_kf_a_valid"], tr._ts_origin)]
        rep = multimap_report(
            tuple(x.cpu().numpy() for x in (tr.map.kf_valid, tr.map.kf_R, tr.map.kf_t,
                                            tr.map.kf_ts)),
            origins, ev["spawn"], ev["merge"], poses, states)
        kf_ate_m, ate_a, ate_b = (rep[k] if rep[k] is not None else float("inf")
                                  for k in ("kf_ate_merged_m", "ate_a_m", "ate_b_m"))
    log(f"[smoke] M (multi-map, frames {g0}-{g1} grey): {len(frames)} frames, median "
        f"{np.median(frame_ms):.2f} ms, p90 {np.percentile(frame_ms, 90):.2f} ms per "
        f"frame; spawn {ev['spawn']}, merge {ev['merge']}; KFs {st['n_kf']} made, map "
        f"{info_end}; track_fail {st['track_fail']}, loops {st['n_loops']}; merged-map "
        f"keyframe ATE {kf_ate_m:.6f} m, map A's frames {ate_a:.6f} m, B's {ate_b:.6f} m "
        f"(reference {REF_MULTIMAP}); launches {launches}, kernel 2 in the merge "
        f"{merge_launches}")
    per = {n: t.ms() for n, t in timers.items()}
    sim3_ms = [a + b for a, b in zip(per["sim3_ransac"], per["optimize_sim3"])]
    print("M merge stages, device ms (CUDA events): "
          + "; ".join(stage_line(n, per[n]) for n in ("archive query", "cross match"))
          + "; " + stage_line("Sim(3) (RANSAC + OptimizeSim3)", sim3_ms) + "; "
          + "; ".join(stage_line(n, per[n]) for n in ("transform + merge_into",
                                                       "welding BA", "BoW rebuild")))
    if ok_ev:
        print(f"M device memory: peak {peak['spawn'] / 2**20:.1f} MiB allocated up to "
              f"the spawn (one map), {peak['merge'] / 2**20:.1f} MiB up to the merge (two "
              f"maps); one map's tensors {map_bytes / 2**20:.1f} MiB")

    # the saved files in a fresh System on the card
    loads_ok = {}
    for key, (path, maps, info, frame) in snaps.items():
        fresh = System(orbit_tracking_config(rig), "stereo", device=dev)
        fresh.load_atlas(path)
        got = fresh.tracker.atlas.maps
        loads_ok[key] = (len(got) == len(maps) and fresh.map_info() == info and all(
            torch.equal(getattr(a, k), torch.from_numpy(b[k]).to(dev))
            for a, b in zip(got, maps) for k in ms.FIELDS)
            and all(m.kf_R.device == dev for m in got))
        log(f"[smoke] M: atlas saved at frame {frame} ({len(maps)} maps, {info}), "
            f"{os.path.getsize(path) / 2**20:.1f} MiB; loaded on the card equal: "
            f"{loads_ok[key]}")
        fresh.shutdown()
        os.remove(path)
        os.rmdir(os.path.dirname(path))
    ref = REF_MULTIMAP
    checks = {
        "M: one map archived, one merge, one map at the end":
            st["n_new_maps"] == 1 and st["n_map_merges"] == 1 and info_end["n_maps"] == 1,
        "M: map A above 10 keyframes": ok_ev and ev["spawn"]["n_kf_a"] > 10,
        "M: merge frame within 2 of the reference's":
            ok_ev and abs(ev["merge"]["frame"] - ref["merge_frame"]) <= 2,
        "M: merged keyframe count within 2 of the reference's":
            ok_ev and abs(ev["merge"]["n_kf_after"] - ref["n_kf_merged"]) <= 2,
        "M: merged map's keyframe ATE within the reference's bound":
            ate_within(kf_ate_m, ref["kf_ate_merged_m"]),
        "M: map A's trajectory ATE within the reference's bound":
            ate_within(ate_a, ref["ate_a_m"]),
        "M: map B's trajectory ATE within the reference's bound":
            ate_within(ate_b, ref["ate_b_m"]),
        "M: kernel 1 once per frame": launches["fast_scores_nms"] == len(frames),
        "M: kernel 2 inside the merge": len(merge_launches) == 1 and merge_launches[0] >= 1,
        "M: the atlas saved after the spawn loads equal": loads_ok.get("spawn", False),
        "M: the atlas saved after the merge loads equal": loads_ok.get("merge", False),
        "M: state OK at the end": states[-1] == 1,
    }
    return checks, launches


def jolt_prior(dev):
    from orbslam3lib_tpu_torch.utils import lie
    return (lie.so3_exp(torch.tensor(JOLT_PRIOR[0], device=dev)),
            torch.tensor(JOLT_PRIOR[1], device=dev))


def run_frames(sys_, frames, jolt_frame, dev):
    """Feed (entry point arguments) per frame to `sys_`, the wrong motion
    prior before frame `jolt_frame`, each frame synchronised; the launch
    counters zeroed just before and read just after. Returns the results,
    host ms per frame and the launches."""
    entry = sys_.track_monocular if sys_.sensor == "mono" else sys_.track_rgbd
    jolt = jolt_prior(dev)
    torch.cuda.synchronize()
    reset_launches()
    results, frame_ms = [], []
    for i, args in enumerate(frames):
        if i == jolt_frame:
            sys_.tracker.vel = jolt
        t0 = time.perf_counter()
        results.append(entry(*args))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    return results, frame_ms, launches


def phase_mono(dev, imgs, ts, rig):
    """Phase O: monocular SLAM through `System.track_monocular`."""
    from orbslam3lib_tpu_torch.io.synthetic import orbit_tracking_config
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking import matching, tracker as ttr
    timers = {"match_for_initialization": StepTimer(matching.match_for_initialization),
              "reconstruct_two_views": StepTimer(ttr.reconstruct_two_views),
              "_mono_init_map": StepTimer(ttr._mono_init_map)}
    saved = (matching.match_for_initialization, ttr.reconstruct_two_views, ttr._mono_init_map)
    init_depth = []

    def init_map(*a, **k):
        out = timers["_mono_init_map"](*a, **k)
        m = ms.to_numpy(out[0])
        z = np.sort(m["mp_pos"][m["mp_valid"]][:, 2])
        init_depth.append(float(z[(len(z) - 1) // 2]))      # the lower median
        return out

    sys_ = System(orbit_tracking_config(rig), "mono", device=dev)
    matching.match_for_initialization = timers["match_for_initialization"]
    ttr.reconstruct_two_views = timers["reconstruct_two_views"]
    ttr._mono_init_map = init_map
    try:
        results, frame_ms, launches = run_frames(
            sys_, [(imgs[i, 0], float(ts[i])) for i in range(N_MONO)], MONO_JOLT_FRAME, dev)
    finally:
        matching.match_for_initialization, ttr.reconstruct_two_views, ttr._mono_init_map = \
            saved
    tr = sys_.tracker
    st = sys_.get_stats()
    sys_.shutdown()
    states = [int(r["state"]) for r in results]
    init_frame = next((i for i, r in enumerate(results) if r.get("init")), None)
    ate = trajectory_ate(tr, ts, with_scale=True)
    ref = REF_MONO
    log(path_line("O (monocular)", frame_ms, sys_, launches, ate,
                  f"; initialised at frame {init_frame} (reference {ref['init_frame']}), "
                  f"initial map's median depth {init_depth}; fallbacks "
                  f"{st['ref_kf_fallbacks']}, jolted frame {results[MONO_JOLT_FRAME]}"))
    per = {n: t.ms() for n, t in timers.items()}
    n_att = len(timers["reconstruct_two_views"].events)
    print(f"O mono: median {np.median(frame_ms):.2f} ms, p90 {np.percentile(frame_ms, 90):.2f} "
          f"ms per frame; init frame {init_frame}, {st['n_kf']} KFs, {st['track_fail']} "
          f"failures; Sim(3)-aligned ATE {ate:.6f} m (reference {ref['ate_sim3_m']}); "
          "initialisation, device ms per attempt (CUDA events): "
          + "; ".join(stage_line(n, per[n]) for n in timers)
          + f"; host syncs per attempt: "
          + ", ".join(f"{n} {len(t.syncs) / max(len(t.events), 1):.1f}"
                      for n, t in timers.items()) + f" ({n_att} reconstructions)")
    checks = {
        "O: initialisation frame within MONO_INIT_TOL of the reference's":
            init_frame is not None and abs(init_frame - ref["init_frame"]) <= MONO_INIT_TOL,
        "O: one initialisation, its map at median depth 1":
            len(init_depth) == 1 and abs(init_depth[0] - 1.0) < 1e-3,
        "O: keyframes within 2 of the reference's": abs(st["n_kf"] - ref["n_kf"]) <= 2,
        "O: no failure, state OK from the initialisation on":
            st["track_fail"] == 0 and init_frame is not None
            and all(s == 1 for s in states[init_frame:]),
        "O: the jolted frame took the fallback and tracked":
            st["ref_kf_fallbacks"] >= 1 and states[MONO_JOLT_FRAME] == 1,
        "O: Sim(3)-aligned ATE within the reference's bound": ate_within(ate, ref["ate_sim3_m"]),
        "O: kernel 1 once per frame": launches["fast_scores_nms"] == N_MONO,
        "O: kernel 2 launched": launches["knn_match_fused"] >= 1,
    }
    return checks, launches


def phase_rgbd(dev, imgs, ts, depths, rig):
    """Phase R: RGB-D through `System.track_rgbd`."""
    from orbslam3lib_tpu_torch.io.synthetic import orbit_tracking_config
    from orbslam3lib_tpu_torch.system import System
    sys_ = System(orbit_tracking_config(rig), "rgbd", device=dev)
    gather = StepTimer(sys_.tracker._rgbd_observations)
    sys_.tracker._rgbd_observations = gather
    results, frame_ms, launches = run_frames(
        sys_, [(imgs[i, 0], depths[i], float(ts[i])) for i in range(N_RGBD)],
        RGBD_JOLT_FRAME, dev)
    st = sys_.get_stats()
    sys_.shutdown()
    ate = trajectory_ate(sys_.tracker, ts)
    ref = REF_RGBD
    log(path_line("R (RGB-D)", frame_ms, sys_, launches, ate,
                  f"; depth gather: {len(gather.events)} calls, host syncs "
                  f"{len(gather.syncs)}, device {stage_line('ms', gather.ms())}; fallbacks "
                  f"{st['ref_kf_fallbacks']}, jolted frame {results[RGBD_JOLT_FRAME]}"))
    print(f"R rgbd: median {np.median(frame_ms):.2f} ms, p90 {np.percentile(frame_ms, 90):.2f} "
          f"ms per frame; {st['n_kf']} KFs; ATE {ate:.6f} m (reference {ref['ate_m']})")
    checks = {
        "R: state OK, no failure": all(int(r["state"]) == 1 for r in results)
            and st["track_fail"] == 0,
        "R: keyframes within 2 of the reference's": abs(st["n_kf"] - ref["n_kf"]) <= 2,
        "R: the jolted frame took the fallback": st["ref_kf_fallbacks"] >= 1,
        "R: ATE within the reference's bound": ate_within(ate, ref["ate_m"]),
        "R: kernel 1 once per frame": launches["fast_scores_nms"] == N_RGBD,
        "R: kernel 2 launched": launches["knn_match_fused"] >= 1,
        "R: depth gathered on every frame, no host sync":
            len(gather.events) == N_RGBD and not gather.syncs,
    }
    return checks, launches


def render_imu(n: int):
    """Phase I's frames (f32 stereo pairs, the grey window applied), stamps
    and IMU stream (numpy only; runs in a worker process)."""
    from orbslam3lib_tpu_torch.config import ImuConfig
    from orbslam3lib_tpu_torch.io import synthetic as syn
    t0 = time.perf_counter()
    frames, _, _ = syn.render_stereo_sequence(n, syn.StereoRig(), seed=5)
    imgs = np.stack([f[0] for f in frames])
    imgs[IMU_GREY[0]:IMU_GREY[0] + IMU_GREY[1]] = 128.0
    ts = np.array([f[2] for f in frames])
    ci = ImuConfig()
    imu = syn.corridor_imu_stream(ts, ci.noise_gyro, ci.noise_acc, ci.freq,
                                  bg=IMU_BG, ba=IMU_BA, seed=0)
    return imgs, ts, imu, time.perf_counter() - t0


class PeakTimer(StepTimer):
    """A StepTimer that also keeps each call's peak device memory (the
    allocator's count, read on the host without waiting) and a label
    (the VI window's size)."""

    def __init__(self, fn, label=None):
        super().__init__(fn)
        self.peaks, self.labels, self.label = [], [], label

    def __call__(self, *args, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        out = super().__call__(*args, **kwargs)
        self.peaks.append(torch.cuda.max_memory_allocated() / 2**20)
        self.labels.append(self.label(*args, **kwargs) if self.label else None)
        return out


def feed_imu_launches(tr, sample) -> dict:
    """Kernel and graph launches per `feed_imu` (cudaLaunchKernel and
    cudaGraphLaunch calls), counted by torch.profiler over 5 calls on the
    phase's tracker after its frames."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            tr.feed_imu(*sample)
        torch.cuda.synchronize()
    return {k: sum(e.count for e in prof.key_averages() if e.key == k) / 5
            for k in ("cudaLaunchKernel", "cudaGraphLaunch")}


def phase_imu(dev, imgs, ts, imu):
    """Phase I: stereo-inertial SLAM through `System.track_stereo`."""
    from orbslam3lib_tpu_torch.device import card_line
    from orbslam3lib_tpu_torch.evaluation import imu_report
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, orbit_tracking_config
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    sys_ = System(orbit_tracking_config(StereoRig()), "imu_stereo", device=dev)
    tr = sys_.tracker
    solve = StepTimer(tr._inertial_refine)
    vi = PeakTimer(ttr.local_inertial_ba, label=lambda m, ids, *a, **k: int(ids.shape[0]))
    init = StepTimer(tr._initialize_imu)
    full = StepTimer(tr._run_full_inertial_ba)
    feed = tr.feed_imu
    feed_ms = []

    def feed_timed(*a):
        t0 = time.perf_counter()
        feed(*a)
        feed_ms.append((time.perf_counter() - t0) * 1e3)

    saved = ttr.local_inertial_ba
    ttr.local_inertial_ba = vi
    tr._initialize_imu, tr._run_full_inertial_ba, tr.feed_imu = init, full, feed_timed
    tr._inertial_refine = solve
    ev = {"imu_init_frame": None, "viba1_frame": None, "viba2_frame": None}
    jolt = torch.tensor(IMU_JOLT_V, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    results, frame_ms, fallback_frames = [], [], []
    try:
        for i in range(N_IMU):
            if i == IMU_JOLT_FRAME:
                tr.frame_state_v = tr.frame_state_v + jolt
            n_fb = tr.stats["ref_kf_fallbacks"]
            t0 = time.perf_counter()
            results.append(sys_.track_stereo(imgs[i], float(ts[i]), imu=imu[i]))
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if tr.stats["ref_kf_fallbacks"] > n_fb:
                fallback_frames.append(i)
            for key, hit in (("imu_init_frame", tr.imu_ready), ("viba1_frame", tr._viba_stage >= 1),
                             ("viba2_frame", tr._viba_stage >= 2)):
                if ev[key] is None and hit:
                    ev[key] = i
        launches = launch_counts()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        feed_launches = feed_imu_launches(tr, imu[1])
    finally:
        ttr.local_inertial_ba = saved
    st = sys_.get_stats()
    m = tr.map
    arrays = tuple(x.cpu().numpy() for x in (m.kf_valid, m.kf_R, m.kf_t, m.kf_ts))
    grey = range(IMU_GREY[0], IMU_GREY[0] + IMU_GREY[1])
    rep = imu_report(tr.trajectory, arrays, tr._ts_origin, ts[list(grey)],
                     (m.kf_bg.cpu().numpy(), m.kf_ba.cpu().numpy()), tr._imu_init_ts)
    bg, ba = (x.cpu().numpy().astype(np.float64) for x in tr.imu_bias)
    sys_.shutdown()
    ref = REF_IMU
    states = [int(r["state"]) for r in results]
    fail_frames = [i for i, s_ in enumerate(states) if s_ != 1]
    centres = tr.trajectory_centers()
    n_solves, solve_syncs = len(solve.events), len(solve.syncs)
    graphs = {n: (len(g.graphs), list(g.eager.values())) for n, g in
              (("anchor", tr._solve_anchor), ("prior", tr._solve_prior))}
    vi_by_c = {}
    for c, ms_, pk in zip(vi.labels, vi.ms(), vi.peaks):
        vi_by_c.setdefault(c, []).append((ms_, pk))
    full_ms = full.ms()
    card = card_line()
    log(f"[smoke] I (stereo-inertial; {card}): {N_IMU} frames, median "
        f"{np.median(frame_ms):.2f} ms, "
        f"p90 {np.percentile(frame_ms, 90):.2f} ms per frame; events {ev} (reference "
        f"{ref['imu_init_frame']}, {ref['viba1_frame']}, {ref['viba2_frame']}); failures "
        f"{fail_frames}; fallbacks on {fallback_frames}; KFs {st['n_kf']} made (reference "
        f"{ref['n_kf']}), relocalisations {st['n_reloc']}, loops {st['n_loops']}; {rep}; "
        f"the last frame's bias g {bg.round(6).tolist()}, a {ba.round(6).tolist()} (the "
        f"reference's over its last 30 frames: {list(ref['bias_range'])}); the keyframes' "
        f"median bias g {np.round(rep['kf_bias_g'], 6).tolist()} (reference "
        f"{list(ref['kf_bias_g'])}), a {np.round(rep['kf_bias_a'], 6).tolist()} (reference "
        f"{list(ref['kf_bias_a'])}); launches {launches}")
    print(f"I imu ({card}): median {np.median(frame_ms):.2f} ms, p90 "
          f"{np.percentile(frame_ms, 90):.2f} ms "
          f"per frame; feed_imu host ms median {np.median(feed_ms):.3f}, p90 "
          f"{np.percentile(feed_ms, 90):.3f} over {len(feed_ms)}, launches per call "
          f"{feed_launches} (graphs captured {len(tr._integrate_pair.graphs)}, eager "
          f"{list(tr._integrate_pair.eager.values())}); per-frame inertial solve (`_inertial_refine`, the graph's input "
          f"copies, replay and output clones), device ms (CUDA events): "
          + stage_line("solve", solve.ms())
          + f"; host syncs {solve_syncs} over {n_solves} solves (CUDA graphs captured, eager "
          f"fallbacks: {graphs}); VI windows (C keyframes: "
          + "; ".join(f"C={c}: " + stage_line("device ms", [x for x, _ in v])
                      + f", peak {max(p for _, p in v):.1f} MiB" for c, v in sorted(vi_by_c.items()))
          + f"); _initialize_imu {stage_line('device ms', init.ms())}; VIBA1 "
          f"{full_ms[0] if full_ms else float('nan'):.2f} ms, VIBA2 "
          f"{full_ms[1] if len(full_ms) > 1 else float('nan'):.2f} ms (CUDA events); peak device "
          f"memory {peak_mb:.1f} MiB")

    def near(a, b):
        return all(abs(x - y) <= 0.2 * abs(y) + 1e-3 for x, y in zip(a, b))

    checks = {
        "I: IMU initialisation frame within 2 of the reference's":
            ev["imu_init_frame"] is not None
            and abs(ev["imu_init_frame"] - ref["imu_init_frame"]) <= 2,
        "I: VIBA1 and VIBA2 ran": ev["viba1_frame"] is not None
            and ev["viba2_frame"] is not None and len(full_ms) == 2,
        "I: the reference's failures (the grey frames)":
            st["track_fail"] == ref["track_fail"] and fail_frames == list(grey),
        "I: state OK at the end": states[-1] == 1 and int(tr.state) == 1,
        "I: keyframes within 2 of the reference's": abs(st["n_kf"] - ref["n_kf"]) <= 2,
        "I: the jolted frame took the fallback and tracked":
            IMU_JOLT_FRAME in fallback_frames and states[IMU_JOLT_FRAME] == 1,
        "I: ATE within the reference's bound": ate_within(rep["ate_m"], ref["ate_m"]),
        "I: keyframe ATE within the reference's bound":
            rep["kf_ate_m"] is not None and ate_within(rep["kf_ate_m"], ref["kf_ate_m"]),
        "I: the grey frames' error within the reference's bound":
            rep["grey_err_m"] is not None and ate_within(rep["grey_err_m"], ref["grey_err_m"]),
        "I: bias estimates (the keyframes' median) within 20% + 1e-3 of the reference's":
            near(rep["kf_bias_g"], ref["kf_bias_g"]) and near(rep["kf_bias_a"], ref["kf_bias_a"]),
        "I: the last frame's bias inside the reference's last 30 frames' range":
            all(lo <= x <= hi for x, (lo, hi) in zip(np.concatenate([bg, ba]),
                                                     ref["bias_range"])),
        "I: kernel 1 once per frame": launches["fast_scores_nms"] == N_IMU,
        "I: kernel 2 launched": launches["knn_match_fused"] >= 1,
        "I: every VI window evaluation by the kernels": st["vi_evals_torch"] == 0
            and launches["vi_eval"] == launches["vi_step"] == st["vi_evals_fused"] > 0,
        "I: finite poses": len(centres) == N_IMU and bool(np.isfinite(centres).all()),
    }
    return checks, launches


def render_imu_mono(n: int):
    """Phase J's left images, stamps and IMU stream (numpy only; runs in a
    worker process)."""
    from orbslam3lib_tpu_torch.config import ImuConfig
    from orbslam3lib_tpu_torch.io import synthetic as syn
    t0 = time.perf_counter()
    world = syn.CorridorWorld(z1=IMU_MONO_Z1)
    imgs, ts, _ = syn.render_corridor_mono(n, world=world, seed=5, speed=IMU_MONO_SPEED,
                                           wiggle=IMU_MONO_WIGGLE)
    ci = ImuConfig()
    imu = syn.corridor_imu_stream(ts, ci.noise_gyro, ci.noise_acc, ci.freq, bg=IMU_BG,
                                  ba=IMU_BA, seed=0, speed=IMU_MONO_SPEED,
                                  wiggle=IMU_MONO_WIGGLE)
    return imgs, ts, imu, time.perf_counter() - t0


def phase_imu_mono(dev, imgs, ts, imu):
    """Phase J: monocular-inertial SLAM through `System.track_monocular`."""
    from orbslam3lib_tpu_torch.device import card_line
    from orbslam3lib_tpu_torch.evaluation import imu_mono_report
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, orbit_tracking_config
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    sys_ = System(orbit_tracking_config(StereoRig()), "imu_mono", device=dev)
    tr = sys_.tracker
    solve = StepTimer(tr._inertial_refine)
    vi = PeakTimer(ttr.local_inertial_ba, label=lambda m, ids, *a, **k: int(ids.shape[0]))
    init = StepTimer(tr._initialize_imu)
    full = StepTimer(tr._run_full_inertial_ba)
    refine = StepTimer(tr._refine_scale)
    frame = [0]
    solves = []
    real_solve = ttr.inertial_init_optimization

    def solve_logged(kf_R, *a, **k):
        out = real_solve(kf_R, *a, **k)
        solves.append({"frame": frame[0], "n_kf": int(kf_R.shape[0]), "s": float(out[3]),
                       "ready": bool(tr.imu_ready), "n_kf_made": tr.stats["n_kf"]})
        return out

    saved = (ttr.local_inertial_ba, ttr.inertial_init_optimization)
    ttr.local_inertial_ba, ttr.inertial_init_optimization = vi, solve_logged
    tr._initialize_imu, tr._run_full_inertial_ba, tr._refine_scale = init, full, refine
    tr._inertial_refine = solve
    ev = {"map_init_frame": None, "imu_init_frame": None, "viba1_frame": None,
          "viba2_frame": None}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    results, frame_ms, fallback_frames = [], [], []
    try:
        for i in range(N_IMU_MONO):
            frame[0] = i
            n_fb = tr.stats["ref_kf_fallbacks"]
            t0 = time.perf_counter()
            results.append(sys_.track_monocular(imgs[i], float(ts[i]), imu=imu[i]))
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if tr.stats["ref_kf_fallbacks"] > n_fb:
                fallback_frames.append(i)
            for key, hit in (("map_init_frame", int(results[-1]["state"]) == 1),
                             ("imu_init_frame", tr.imu_ready),
                             ("viba1_frame", tr._viba_stage >= 1),
                             ("viba2_frame", tr._viba_stage >= 2)):
                if ev[key] is None and hit:
                    ev[key] = i
        launches = launch_counts()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
    finally:
        ttr.local_inertial_ba, ttr.inertial_init_optimization = saved
    st = sys_.get_stats()
    m = tr.map
    arrays = tuple(x.cpu().numpy() for x in (m.kf_valid, m.kf_R, m.kf_t, m.kf_ts))
    rep = imu_mono_report(tr.trajectory, arrays, tr._ts_origin, tr._imu_init_ts,
                          (m.kf_bg.cpu().numpy(), m.kf_ba.cpu().numpy()),
                          IMU_MONO_SPEED, IMU_MONO_WIGGLE)
    sys_.shutdown()
    ref = REF_IMU_MONO
    states = [int(r["state"]) for r in results]
    init_frame = ev["map_init_frame"]
    fail_frames = [i for i, s_ in enumerate(states)
                   if s_ != 1 and init_frame is not None and i > init_frame]
    attempts = [x for x in solves if not x["ready"]]
    refinements = [dict(x, applied=0.5 < x["s"] < 2.0) for x in solves if x["ready"]]
    init_kf = next((x["n_kf_made"] for x in attempts if x["s"] >= 0.1), None)
    centres = tr.trajectory_centers()
    vi_by_c = {}
    for c, ms_, pk in zip(vi.labels, vi.ms(), vi.peaks):
        vi_by_c.setdefault(c, []).append((ms_, pk))
    card = card_line()
    log(f"[smoke] J (monocular-inertial, {IMU_MONO_SPEED} m/s, sway {IMU_MONO_WIGGLE} m; "
        f"{card}): {N_IMU_MONO} frames; events {ev} (reference "
        f"{[ref[k] for k in ev]}); initialisation attempts "
        f"{[(x['frame'], x['n_kf'], round(x['s'], 6)) for x in attempts]} (the IMU "
        f"initialised at keyframe {init_kf}, reference {ref['imu_init_kf']} at scale "
        f"{ref['init_scale']}); scale "
        f"refinements {[(x['frame'], round(x['s'], 6), x['applied']) for x in refinements]} "
        f"(reference {ref['refinements']}); failures {fail_frames} (reference "
        f"{ref['fail_frames']}); fallbacks on {fallback_frames}; KFs {st['n_kf']} made "
        f"(reference {ref['n_kf']}), relocalisations {st['n_reloc']}, resets "
        f"{st['n_resets']}, new maps {st['n_new_maps']}; {rep}; launches {launches}")
    print(f"J imu_mono ({card}): median {np.median(frame_ms):.2f} ms, p90 "
          f"{np.percentile(frame_ms, 90):.2f} ms per frame; per-frame inertial solve, device "
          f"ms (CUDA events): " + stage_line("solve", solve.ms())
          + f"; host syncs {len(solve.syncs)} over {len(solve.events)} solves; "
          f"initialisation attempts (`_initialize_imu`) device ms "
          f"{[round(x, 2) for x in init.ms()]}; VIBA1 / VIBA2 device ms "
          f"{[round(x, 2) for x in full.ms()]}; scale refinements device ms "
          f"{[round(x, 2) for x in refine.ms()]}; VI windows (C keyframes: "
          + "; ".join(f"C={c}: " + stage_line("device ms", [x for x, _ in v])
                      + f", peak {max(p for _, p in v):.1f} MiB" for c, v in sorted(vi_by_c.items()))
          + f"); peak device memory {peak_mb:.1f} MiB")

    def bounded(b, limit):
        return b is not None and bool(np.all(np.abs(np.asarray(b)) <= limit))

    checks = {
        "J: the map's initialisation frame within MONO_INIT_TOL of the reference's":
            init_frame is not None and abs(init_frame - ref["map_init_frame"]) <= MONO_INIT_TOL,
        "J: the IMU initialisation within 2 keyframes of the reference's":
            init_kf is not None and abs(init_kf - ref["imu_init_kf"]) <= 2,
        "J: VIBA1 ran": ev["viba1_frame"] is not None,
        "J: VIBA2 ran where the reference's did":
            ref["viba2_frame"] is None or (ev["viba2_frame"] is not None and len(full.ms()) == 2),
        "J: the scale refinements the reference ran":
            len(refinements) == len(ref["refinements"]),
        "J: the failures' outcome as the reference's: no reset, no new map":
            (st["n_resets"], st["n_new_maps"]) == (ref["n_resets"], ref["n_new_maps"]),
        "J: keyframes within 2 of the reference's": abs(st["n_kf"] - ref["n_kf"]) <= 2,
        "J: ATE after the IMU initialisation within the reference's bound":
            rep["ate_post_init_m"] is not None
            and ate_within(rep["ate_post_init_m"], ref["ate_post_init_m"]),
        "J: the Sim(3) scale's distance from 1 within the reference's bound":
            rep["sim3_scale"] is not None and abs(rep["sim3_scale"] - 1.0)
            <= 1.5 * abs(ref["sim3_scale"] - 1.0) + 0.02,
        "J: the keyframes' median bias finite and within IMU_MONO_BIAS_MAX":
            bounded(rep.get("kf_bias_g"), IMU_MONO_BIAS_MAX[0])
            and bounded(rep.get("kf_bias_a"), IMU_MONO_BIAS_MAX[1]),
        "J: kernel 1 once per frame": launches["fast_scores_nms"] == N_IMU_MONO,
        "J: kernel 2 launched": launches["knn_match_fused"] >= 1,
        "J: every VI window evaluation by the kernels": st["vi_evals_torch"] == 0
            and launches["vi_eval"] == launches["vi_step"] == st["vi_evals_fused"] > 0,
        "J: finite poses": len(centres) > 0 and bool(np.isfinite(centres).all())
            and rep["nonfinite_frames"] == 0,
    }
    return checks, launches


def phase_fixed_window(dev, imgs, ts, rig):
    """Phase W: the fixed local-BA window (`cfg.mapping.covis_ba_window =
    False`) through `System.track_stereo`."""
    from orbslam3lib_tpu_torch.io.synthetic import orbit_tracking_config
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    cfg = orbit_tracking_config(rig)
    cfg.mapping.covis_ba_window = False
    windows = []
    real = ttr._local_ba

    def recorded(m, ids, fixed, *a, **k):
        windows.append((ids.tolist(), fixed.tolist()))
        return real(m, ids, fixed, *a, **k)
    ttr._local_ba = recorded
    try:
        sys_, results, frame_ms, launches = run_system(
            cfg, [(imgs[i], float(ts[i])) for i in range(N_FIXED_WINDOW)], dev)
    finally:
        ttr._local_ba = real
    ate = trajectory_ate(sys_.tracker, ts[:N_FIXED_WINDOW])
    st = sys_.get_stats()
    n = st["n_kf"]
    # local BA i runs when the map holds i + 3 keyframe slots
    fixed = [[a.tolist() for a in ttr.fixed_ba_window(i + 3, cfg.ba.window_size,
                                                      cfg.ba.n_fixed)]
             for i in range(len(windows))]
    log(path_line("W (fixed local-BA window)", frame_ms, sys_, launches, ate,
                  f"; local BAs {len(windows)}, last window {windows[-1] if windows else None}"))
    print(f"W fixed window: median {np.median(frame_ms):.2f} ms, p90 "
          f"{np.percentile(frame_ms, 90):.2f} ms per frame; {n} KFs; ATE {ate:.6f} m "
          f"(reference {REF_FIXED_WINDOW['ate_m']})")
    checks = {
        "W: state OK, no failure": all(r["state"] == 1 for r in results)
            and st["track_fail"] == 0,
        "W: keyframes within +-2 of the reference's": abs(n - REF_FIXED_WINDOW["n_kf"]) <= 2,
        "W: local BA over the fixed window from the third keyframe on":
            len(windows) == n - 2 and [list(w) for w in windows] == fixed,
        "W: kernel 1 once per frame": launches["fast_scores_nms"] == N_FIXED_WINDOW,
        "W: ATE within the reference's bound": ate_within(ate, REF_FIXED_WINDOW["ate_m"]),
    }
    return checks, launches


def phase_native(dev, tracker):
    """Phase N: the native BoW database, built with g++ here, on phase 3's
    final map: word ids against the dense descent on the card, query
    scores and top-3 against the dense database, host ms per query beside
    the dense query's device ms; then the native loop probe keyframe by
    keyframe (each added just before its probe), its packs consumed by a
    loop closer on a copy of the map (kernel 2 in any verification)."""
    from orbslam3lib_tpu_torch import native
    from orbslam3lib_tpu_torch.mapping.loop_closing import LoopCloser
    from orbslam3lib_tpu_torch.models import map_state as ms, vocabulary as vb
    from orbslam3lib_tpu_torch.tracking.reloc import PlaceRecognition
    t0 = time.perf_counter()
    native.build()                  # a failed build raises: no dense fallback here
    native.library()
    build_s = time.perf_counter() - t0
    m = tracker.map
    voc = tracker.place_rec.voc
    K = m.max_kf
    ids = np.flatnonzero(m.kf_valid.cpu().numpy())
    desc_h = m.kf_desc.cpu().numpy()
    valid_h = m.kf_feat_valid.cpu().numpy()
    nvoc = native.NativeVocabulary(voc)
    words_equal = all(np.array_equal(nvoc.word_ids(desc_h[k]),
                                     vb.word_ids(voc, m.kf_desc[k]).cpu().numpy()) for k in ids)
    nb, dense = native.NativeBowDatabase(voc, K), PlaceRecognition(voc, K)
    for k in ids:
        nb.add(int(k), desc_h[k], valid_h[k])
        dense.add(int(k), m.kf_desc[k], m.kf_feat_valid[k])
    score_err, top3_equal, host_ms, dev_ms = 0.0, True, [], []
    for k in ids:
        t1 = time.perf_counter()
        ids_n, s_n = nb.query(desc_h[k], valid_h[k], n_best=3)
        host_ms.append((time.perf_counter() - t1) * 1e3)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ids_d, s_d = dense.query(m.kf_desc[k], m.kf_feat_valid[k], n_best=3)
        e1.record()
        torch.cuda.synchronize()
        dev_ms.append(e0.elapsed_time(e1))
        all_n = nb.query_scores(desc_h[k], valid_h[k])
        all_d = torch.where(dense.active, vb.l1_scores(dense.bow_db, vb.bow_from_descriptors(
            voc, m.kf_desc[k], m.kf_feat_valid[k])), -1.0).cpu().numpy()
        score_err = max(score_err, float(np.abs(all_n - all_d).max()))
        top3_equal &= np.array_equal(ids_n, ids_d.cpu().numpy())
    # the native probe on a copy of the map
    m2 = ms.clone_map(m)
    nb_probe = native.NativeBowDatabase(voc, K)
    lc = LoopCloser(tracker.cfg, nb_probe, fix_scale=True)
    torch.cuda.synchronize()
    reset_launches()
    packs, probe_ms = [], []
    for i, k in enumerate(ids):
        nb_probe.add(int(k), desc_h[k], valid_h[k])
        t1 = time.perf_counter()
        pack = lc.dispatch_probe(m2, int(k), i + 1)
        if pack is None:
            continue
        probe_ms.append((time.perf_counter() - t1) * 1e3)
        packs.append(pack)
        m2 = lc.on_probe_result(m2, int(k), pack, tracker.cam_params)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[smoke] N (native BoW, g++ build {build_s:.2f} s): {len(ids)} keyframes; word ids "
        f"equal {words_equal}; scores max |native - dense| {score_err:.3g}; top-3 equal "
        f"{top3_equal}; query: native host {np.median(host_ms):.4f} ms, dense device "
        f"{np.median(dev_ms):.4f} ms (medians); native probes {len(packs)}, host "
        f"{np.median(probe_ms) if probe_ms else float('nan'):.3f} ms median, loops "
        f"{lc.n_loops}, consistent candidate {lc.consistent_candidate}; launches {launches}")
    print(f"N native BoW: query {np.median(host_ms):.4f} ms host (native) vs "
          f"{np.median(dev_ms):.4f} ms device (dense); probe {np.median(probe_ms):.3f} ms host")
    checks = {
        "N: native word ids equal the dense descent on the card": words_equal,
        "N: native scores within tolerance of the dense database's":
            score_err <= NATIVE_SCORE_TOL,
        "N: native top-3 equal the dense database's": bool(top3_equal),
        "N: the native probe ran on every keyframe past the gates": len(packs) >= 1
            and all(len(p) == 3 * lc.PROBE_N + 1 for p in packs),
    }
    return checks, launches


def _gba_rank(rank: int, port: int, map_path: str, out_path: str, cam, bf: float,
              device: str) -> None:
    """One rank of phase X's ProcessMesh global BA (a spawned process): the
    saved map on `device` (the one card), a gloo group of two."""
    import torch.distributed as dist
    from orbslam3lib_tpu_torch.mapping.map_ba import global_bundle_adjust_dist
    from orbslam3lib_tpu_torch.models.serialization import load_map, save_map
    from orbslam3lib_tpu_torch.parallel.dist_ba import ProcessMesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        m = load_map(map_path, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = global_bundle_adjust_dist(m, torch.as_tensor(cam, device=device),
                                      ProcessMesh(device=device), bf,
                                      n_iters=GBA_ITERS, chunk=GBA_CHUNK)
        torch.cuda.synchronize()
        ms_ = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            save_map(m, out_path)
            with open(out_path + ".ms", "w") as f:
                f.write(repr(ms_))
    finally:
        dist.destroy_process_group()


def phase_sharded(dev, tracker, imgs):
    """Phase X: the landmark-sharded global BA on phase 3's final map, over
    DeviceMesh(["cuda:0"] * 2), * 4 and a ProcessMesh of 2 spawned gloo
    ranks on cuda:0, each against the plain `global_bundle_adjust`; and the
    sharded front end over DeviceMesh(["cuda:0"] * 2) against the per-frame
    one. One card: this checks the sharded arithmetic, not an
    interconnect."""
    import socket
    from orbslam3lib_tpu_torch.mapping.map_ba import (global_bundle_adjust,
                                                      global_bundle_adjust_dist)
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.models.serialization import load_map, save_map
    from orbslam3lib_tpu_torch.ops.extractor import extract_orb_stereo
    from orbslam3lib_tpu_torch.parallel.dist_ba import DeviceMesh, reduction_numel
    from orbslam3lib_tpu_torch.parallel.dist_frontend import make_sharded_frontend
    from orbslam3lib_tpu_torch.tracking.matching import match_rectified_stereo
    cfg = tracker.cfg
    cam, bf = tracker.cam_params, float(cfg.bf)
    card = str(dev)
    tmp = tempfile.mkdtemp(prefix="smoke_x_")
    map_path = os.path.join(tmp, "map.npz")
    save_map(tracker.map, map_path)

    def timed(fn):
        m = load_map(map_path, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = fn(m)
        torch.cuda.synchronize()
        return m, (time.perf_counter() - t0) * 1e3

    plain, plain_ms = timed(lambda m: global_bundle_adjust(m, cam, bf, n_iters=GBA_ITERS,
                                                           chunk=GBA_CHUNK))
    routes, gaps = {"plain": plain_ms}, {}

    def gap(m):
        return (float((m.kf_R - plain.kf_R).abs().max()), float((m.kf_t - plain.kf_t).abs().max()),
                float((m.mp_pos - plain.mp_pos).abs().max()))
    for n in (2, 4):
        got, t = timed(lambda m: global_bundle_adjust_dist(
            m, cam, DeviceMesh([card] * n), bf, n_iters=GBA_ITERS, chunk=GBA_CHUNK))
        routes[f"device_mesh_{n}"], gaps[f"device_mesh_{n}"] = t, gap(got)
    # ProcessMesh: two spawned ranks, both on cuda:0 (NCCL takes one rank a card)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    out_path = os.path.join(tmp, "out.npz")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gba_rank, args=(r, port, map_path, out_path,
                                                 cam.cpu().numpy(), bf, card))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=max(1.0, GLOO_TIMEOUT_S - (time.perf_counter() - t0)))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    gloo_ok = all(p.exitcode == 0 for p in procs) and os.path.exists(out_path)
    if gloo_ok:
        got = load_map(out_path, device=dev)
        with open(out_path + ".ms") as f:
            routes["process_mesh_2"] = float(f.read())
        gaps["process_mesh_2"] = gap(got)
    shutil.rmtree(tmp, ignore_errors=True)
    C = int(cfg.map.max_kf)
    bytes_per_iter = 4 * reduction_numel(C)
    log(f"[smoke] X global BA ({GBA_ITERS} LM steps, {C} camera slots, {cfg.map.max_mp} "
        f"landmark slots): ms per GBA {routes}; max |dR|, |dt|, |dp| against the plain "
        f"route {gaps}; reduced per iteration {bytes_per_iter} bytes per shard "
        f"(S, b, H_cc in f32); gloo ranks' exit codes {[p.exitcode for p in procs]}")
    print(f"X global BA ms: " + ", ".join(f"{k} {v:.1f}" for k, v in routes.items())
          + f"; {bytes_per_iter} bytes reduced per iteration per shard")

    # the sharded front end on 8 frames
    frames = torch.as_tensor(np.asarray(imgs[:N_SHARDED_FRAMES]))
    ths = torch.full((N_SHARDED_FRAMES,), float(cfg.orb.fast_threshold))
    front = make_sharded_frontend(DeviceMesh([card] * 2), bf=bf, min_z=float(cfg.stereo.min_z),
                                  max_kp=cfg.orb.max_kp, n_levels=cfg.orb.n_levels)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = front(frames, ths)
    torch.cuda.synchronize()
    front_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    ints_equal, depth_err = True, 0.0
    per = N_SHARDED_FRAMES // 2
    for g in range(N_SHARDED_FRAMES):
        f, ur, depth = out[g // per]
        i = g % per
        ref = extract_orb_stereo(frames[g].to(dev), float(ths[g]), max_kp=cfg.orb.max_kp,
                                 n_levels=cfg.orb.n_levels)
        r_ur, r_d = match_rectified_stereo(ref.xy[0], ref.level[0], ref.desc[0], ref.valid[0],
                                           ref.xy[1], ref.level[1], ref.desc[1], ref.valid[1],
                                           bf, float(cfg.stereo.min_z), n_levels=cfg.orb.n_levels)
        ints_equal &= all(torch.equal(getattr(f, n)[i], getattr(ref, n))
                          for n in ("level", "valid", "desc", "xy"))
        depth_err = max(depth_err, float((depth[i] - r_d).abs().max()),
                        float((ur[i] - r_ur).abs().max()))
    log(f"[smoke] X sharded front end: {N_SHARDED_FRAMES} frames over 2 shards on {card} in "
        f"{front_ms:.1f} ms; integer outputs equal to the per-frame run {ints_equal}, max "
        f"|d depth|, |d u_r| {depth_err:.3g}; launches {launches}")
    checks = {f"X: {k} global BA within the reference's tolerances of the plain one":
              v[0] <= DIST_R_TOL and v[1] <= DIST_T_TOL for k, v in gaps.items()}
    checks.update({
        "X: both DeviceMesh routes and the ProcessMesh route ran":
            set(gaps) == {"device_mesh_2", "device_mesh_4", "process_mesh_2"},
        "X: the gloo ranks exited cleanly": gloo_ok,
        "X: sharded front end's integer outputs equal the per-frame run's": bool(ints_equal),
        "X: sharded front end's depths within tolerance": depth_err <= SHARDED_DEPTH_TOL,
        "X: kernel 1 once per shard": launches["fast_scores_nms"] == 2,
    })
    return checks, launches


def render_depths(n: int):
    """Phase R's depth maps (numpy only; runs in a worker process)."""
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, orbit_depth_maps
    t0 = time.perf_counter()
    return orbit_depth_maps(n, StereoRig()), time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        log("[smoke] CUDA is not available: this smoke test needs one CUDA card")
        return 2
    t_start = time.perf_counter()
    # the sequences render in worker processes, forked before CUDA is used
    pool = ProcessPoolExecutor(6, mp_context=multiprocessing.get_context("fork"))
    try:
        jobs = {"pinhole": pool.submit(render, N_FRAMES, {}),
                "radtan": pool.submit(render, N_RADTAN, {"dist": DIST}),
                "kb8": pool.submit(render, N_KB8, KB8_RIG),
                "depths": pool.submit(render_depths, N_RGBD),
                "imu": pool.submit(render_imu, N_IMU),
                "imu_mono": pool.submit(render_imu_mono, N_IMU_MONO)}
        return run(jobs, t_start)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run(jobs, t_start) -> int:
    from orbslam3lib_tpu_torch.device import card_line, device_ms_per_launch
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at, orbit_tracking_config
    from orbslam3lib_tpu_torch.mapping import loop_closing as lc_mod
    from orbslam3lib_tpu_torch.ops import _cuda_lib, pyramid
    from orbslam3lib_tpu_torch.ops.extractor import extract_orb_stereo
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    from orbslam3lib_tpu_torch.tracking.tracker import OK, Tracker

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
    # batch 1: the left image's 8 levels (a mono or RGB-D frame)
    rendered1 = pyramid.build_pyramid(torch.as_tensor(imgs[0][:1], device=dev), 8)
    fast_err = check_fast(dev, gen, rendered, rendered1)
    knn_err = check_knn(dev, gen)
    fast_t = time_fast(rendered)
    knn_t = time_knn(dev, gen)
    fast1_t = {"max_abs_err": fast_err, **time_fast(rendered1)}
    log("[smoke] fast_scores_nms_levels at batch 1 (8 levels of one 640x400 image), "
        "bit-exact, ms: " + ", ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                                      for k, v in fast1_t.items()))
    log(f"[smoke] fast_scores_nms_levels (one frame: 8 levels x 2 eyes, 640x400), ms: "
        + ", ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in fast_t.items()))
    log("[smoke] knn_match_fused (512x512), ms: "
        + ", ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in knn_t.items()))
    pose_gaps = check_pose(dev)
    pose_t = {n: time_pose(dev, n) for n in POSE_SHAPES[:2]}
    pose_solve = pose_solve_cost(dev)
    for n, by_kernel in pose_t.items():
        for name, t in by_kernel.items():
            log(f"[smoke] {name} ({n} rows), ms: "
                + ", ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                            for k, v in t.items()))
    log(f"[smoke] one solve on the kernels and on the torch path: {pose_solve}")
    vi_gaps = check_vi(dev)
    vi_t = {C: time_vi(dev, C) for C in VI_SHAPES}
    vi_cost = {C: vi_window_cost(dev, C) for C in VI_SHAPES}
    for C, by_kernel in vi_t.items():
        for name, t in by_kernel.items():
            log(f"[smoke] {name} (C = {C}, F = {VI_F}), ms: "
                + ", ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                            for k, v in t.items()))
    log(f"[smoke] one window on the kernels and on the torch path: {vi_cost}")

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
    jolt = jolt_prior(dev)
    dt = float(ts[1] - ts[0])
    kid = N_FRAMES - KIDNAP_BACK
    frames = [(imgs[i], float(ts[i])) for i in range(N_FRAMES)] + \
        [(imgs[kid + i], float(ts[-1]) + (i + 1) * dt) for i in range(3)]
    torch.cuda.synchronize()
    reset_launches()
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
    launches = launch_counts()
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
        "every pose evaluation by the kernel": st["pose_evals_torch"] == 0
            and launches["pose_eval"] == st["pose_evals_fused"] > 0
            and launches["pose_step"] > 0,
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
    c, by_path["production"] = phase_production(dev, imgs, ts, rig, med)
    checks.update(c)
    c, by_path["M"] = phase_multimap(dev, imgs, ts, rig)
    checks.update(c)
    c, by_path["mono"] = phase_mono(dev, imgs, ts, rig)
    checks.update(c)
    depths, render_r = jobs["depths"].result()
    c, by_path["rgbd"] = phase_rgbd(dev, imgs, ts, depths, rig)
    checks.update(c)
    del depths
    imgs_i, ts_i, imu_i, render_i = jobs["imu"].result()
    c, by_path["I"] = phase_imu(dev, imgs_i, ts_i, imu_i)
    checks.update(c)
    del imgs_i
    imgs_j, ts_j, imu_j, render_j = jobs["imu_mono"].result()
    c, by_path["J"] = phase_imu_mono(dev, imgs_j, ts_j, imu_j)
    checks.update(c)
    del imgs_j
    c, by_path["W"] = phase_fixed_window(dev, imgs, ts, rig)
    checks.update(c)
    c, by_path["N"] = phase_native(dev, tracker)
    checks.update(c)
    c, by_path["X"] = phase_sharded(dev, tracker, imgs)
    checks.update(c)
    for path, counts in by_path.items():
        for name, n in counts.items():
            # N launches kernel 2 only in a verification and no kernel 1; X
            # no kernel 2 (their own checks say what they must launch); the
            # Kannala-Brandt camera keeps the pose solve's torch path
            if path == "kb8" and name.startswith("pose_"):
                checks[f"{name} not launched on the {path} path"] = n == 0
            elif name.startswith("vi_") and path not in ("I", "J"):
                # the VI window runs only with an IMU
                checks[f"{name} not launched on the {path} path"] = n == 0
            elif path not in ("N", "X"):
                checks[f"{name} launched on the {path} path"] = n >= 1
    log(f"[smoke] rendering (in worker processes): radtan {render_d:.1f} s, kb8 "
        f"{render_f:.1f} s, depth maps {render_r:.1f} s, corridor and IMU {render_i:.1f} s, "
        f"phase J's corridor and IMU {render_j:.1f} s; "
        f"command so far "
        f"{time.perf_counter() - t_start:.1f} s")

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
         "batch1": fast1_t,
         "launches_by_path": {p: c["fast_scores_nms"] for p, c in by_path.items()}},
        {"name": "knn_match_fused", "route": "cuda", "source": src + "knn2.cu",
         "replaces": "orbslam3lib_tpu/ops/pallas_matcher.py:77",
         "launches": launches["knn_match_fused"], "max_abs_err": knn_err,
         **knn_t, "library_ms": None, "ptxas": ptxas.get("knn2_kernel"),
         "launches_by_path": {p: c["knn_match_fused"] for p, c in by_path.items()}},
        {"name": "pose_eval", "route": "cuda", "source": src + "pose_opt.cu",
         "replaces": "orbslam3lib_tpu/tracking/pose_opt.py:47",
         "launches": launches["pose_eval"], "max_abs_err": 0.0,
         **pose_t[1200]["pose_eval"], "library_ms": None, "ptxas": ptxas.get("pose_eval_kernel"),
         "n512": pose_t[512]["pose_eval"], "solve": pose_solve,
         "launches_by_path": {p: c["pose_eval"] for p, c in by_path.items()}},
        {"name": "pose_step", "route": "cuda", "source": src + "pose_opt.cu",
         "replaces": "orbslam3lib_tpu/tracking/pose_opt.py:84",
         "launches": launches["pose_step"], "max_abs_err": pose_gaps[0],
         "solve_max_abs_err": pose_gaps[1],
         **pose_t[1200]["pose_step"], "library_ms": None, "ptxas": ptxas.get("pose_step_kernel"),
         "n512": pose_t[512]["pose_step"],
         "launches_by_path": {p: c["pose_step"] for p, c in by_path.items()}},
        {"name": "vi_eval", "route": "cuda", "source": src + "vi_opt.cu",
         "replaces": "orbslam3lib_tpu_torch/mapping/vi_ba.py (jacobian_fwd over _residuals)",
         "launches": launches["vi_eval"], "max_rel_err": vi_gaps[0],
         **vi_t[9]["vi_eval"], "library_ms": None, "ptxas": ptxas.get("vi_eval_kernel"),
         "C24": vi_t[24]["vi_eval"], "window": vi_cost,
         "launches_by_path": {p: c["vi_eval"] for p, c in by_path.items()}},
        {"name": "vi_step", "route": "cuda", "source": src + "vi_opt.cu",
         "replaces": "orbslam3lib_tpu_torch/mapping/vi_ba.py (J^T J + 1e-5 I, solve_ex)",
         "launches": launches["vi_step"], "window_err_of_limit": vi_gaps[1],
         **vi_t[9]["vi_step"], "library_ms": None, "ptxas": ptxas.get("vi_step_kernel"),
         "C24": vi_t[24]["vi_step"],
         "launches_by_path": {p: c["vi_step"] for p, c in by_path.items()}},
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
