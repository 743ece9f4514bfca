#!/usr/bin/env python3
"""The JAX reference's synchronous tracker at the configurations of
`chip_smoke.py`'s phases, on the CPU: the numbers the smoke's bounds come
from. Needs JAX (it runs where the reference runs, not on the card's
machine).

    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase pinhole
    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase radtan --frames 400
    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase production
    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase multimap
    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase mono [--median-depth]
    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase rgbd
    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase imu [--imu-jolt 3,0,0]
    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase fixed_window

Phases (frames rendered by the port's numpy renderer, the same frames the
smoke feeds the port; bench.py's configuration: 640x400, 512 keypoints, 8
levels, 2x2 pose iterations, loop closing on, `pipeline=0`):
  pinhole  the room orbit, 400 frames, the wrong motion prior before frame
           370 and the kidnap (frame 220's image and two more after the
           last frame), as chip_smoke's slice phase;
  radtan   phase D: raw radial-tangential stereo (bench.py's DIST),
           `cfg.stereo.rectify`;
  kb8      phase F: two-camera Kannala-Brandt stereo, `cfg.stereo.fisheye`;
  fixed_window  phase W: the first 150 pinhole frames with the fixed
           local-BA window (`cfg.mapping.covis_ba_window = False`: the last
           `window_size` keyframes and up to `n_fixed` anchors before them);
  compact  phase C: the first 150 pinhole frames with 24 KF / 2048 MP
           slots, 1024 local-BA points and dense keyframing
           (tests/test_compaction.py::test_long_sequence_with_recycling);
  production  phase P: bench.py's `full_slam` protocol (bench.py:329-440)
           on the first 376 pinhole frames: `Tracker(cfg, "stereo",
           pipeline=16, chunk=4, async_mapping=True)` with
           `cfg.mapping.async_gba`; a populate of 240 frames with the
           mapper queue detached (mapping inline), a keyframe every 2nd
           frame and culling off, `finish()` and `_compact_map()`; then 16
           warm frames and 3 windows of 40, each ended by `_drain_pipeline()`.
           The compile-only warm-ups of bench.py (`_warm_cold_graphs`) are
           left out: they change no state. The reference's chunk reads run
           when submitted (its fetch pool replaced by tests/torch_parity's
           `InlineFetches`), so
           it consumes each chunk right after dispatching it, as the port
           does on the card, where a chunk's device work ends within the
           host's time to enqueue the next. Left to its fetch pool on the
           CPU, whose chunks take seconds, the reference lets chunks pile up
           and decides keyframes on frames tracked against a map that lags
           by up to 16 frames: 152 populate keyframes instead of the 121
           both packages make when each chunk is consumed at once.
  multimap  phase M: the pinhole orbit's 400 frames with frames
           GREY_START..GREY_START+GREY_LEN-1 flat grey (their stamps kept):
           the tracker loses map A there, the 5 s timeout archives it in the
           Atlas and starts map B, which initialises on the first textured
           frame after the window; when the orbit comes back to A's start
           the map merger welds A into B. Prints the spawn and merge frames,
           the maps' keyframe counts, the merged map's keyframe ATE (A's
           keyframes in B's world) and each map's trajectory ATE.
  mono     phase O: the left images of the pinhole orbit's first 130
           frames (the reference loses track at frame 130) through
           `Tracker(cfg, "mono")` (loop closing on, so a loop would run the
           free-scale Sim(3)), with the wrong motion prior of phase 3 before
           frame 100, which takes the TrackReferenceKeyFrame fallback
           (`--frames 400` without it: where it loses track). Prints the initialisation frame, the points
           triangulated there and their median depth (the reference's
           `_mono_init_map` means to scale it to 1 but reads a NaN median,
           so its map keeps the two-view unit baseline), the keyframes,
           failures, the Sim(3)-aligned ATE and each loop's scale. With
           `--median-depth` the initial map is scaled to median depth 1 as
           intended (the lower median of the triangulated depths, as
           ORB-SLAM3's ComputeSceneMedianDepth(2)), for the comparison
           that decides which of the two the port carries.
  rgbd     phase R: the left images of the pinhole orbit's first 180
           frames with the depth maps of `io.synthetic.orbit_depth_maps`
           through the reference's `System(cfg, "rgbd").track_rgbd`, with
           the wrong motion prior before frame 150.
  imu      phase I: stereo-inertial SLAM through the reference's
           `System(cfg, "imu_stereo").track_stereo(pair, ts, imu=...)` on
           the corridor of tests/test_slam_modes.py (seed 5) at 640x400,
           300 frames at 15 FPS, with frames 160-167 flat grey (stamps
           kept: the tracker dead-reckons on the IMU and inserts keyframes
           while lost) and a wrong IMU velocity (`frame_state_v` plus
           `--imu-jolt`, m/s) before frame IMU_JOLT_FRAME, which takes the
           TrackReferenceKeyFrame fallback. The IMU: `synth_imu` at 200 Hz
           between the stamps, noise at cfg.imu's discrete sigmas, constant
           biases IMU_BG / IMU_BA, one `default_rng(0)` through all calls.
           Prints the IMU initialisation and VIBA1 / VIBA2 frames, the
           failures, keyframes, fallbacks, relocalisations, the bias
           estimates (the last frame's, its spread over the last 30
           frames, the last keyframe's and the median of the keyframes'
           since the initialisation), the ATEs (trajectory and keyframes,
           SE(3)) and the largest error of a grey frame
           (`evaluation.imu_report`).
Prints one JSON line per phase: trajectory and keyframe ATE (m, SE(3)
aligned to the analytic orbit), keyframes, loops and their pairs, the loop
frame, failures and (compact) compactions; production also the windows,
the populate's keyframes and live landmarks, and the async GBAs started
and merged.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
KB8_K = (0.02, -0.01, 0.003, 0.0)
DEFAULT_FRAMES = {"pinhole": 400, "radtan": 400, "kb8": 180, "compact": 150,
                  "production": 376, "multimap": 400, "mono": 130, "rgbd": 180,
                  "imu": 300, "fixed_window": 150}
# bench.py's full_slam protocol (bench.py:39-42)
N_POPULATE, N_WARM, N_WINDOWS, N_WINDOW = 240, 16, 3, 40
JOLT_FRAME = 370
JOLT_PRIOR = ((0.0, 0.2, 0.0), (0.3, 0.0, 0.0))
KIDNAP_BACK = 180
# phase O's wrong motion prior (chip_smoke.py's MONO_JOLT_FRAME): kernel 2
# in the TrackReferenceKeyFrame fallback
MONO_JOLT_FRAME = 100
RGBD_JOLT_FRAME = 150   # phase R's (chip_smoke.py's RGBD_JOLT_FRAME)
# phase M's grey window (chip_smoke.py's MULTIMAP_GREY)
GREY_START, GREY_LEN = 180, 80
# phase I (chip_smoke.py's IMU_GREY, IMU_JOLT_FRAME, IMU_JOLT_V, IMU_BG, IMU_BA)
IMU_GREY = (160, 8)
IMU_JOLT_FRAME = 130
IMU_JOLT_V = (10.0, 0.0, 0.0)
IMU_BG = (0.002, -0.001, 0.0015)
IMU_BA = (0.02, -0.01, 0.015)


def bench_config(cfg_cls, rig):
    """bench.py's orbit configuration (as `io.synthetic.orbit_tracking_config`)."""
    cfg = cfg_cls()
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    cfg.orb.max_kp = 512
    cfg.orb.n_levels = 8
    cfg.tracker.pose_rounds = 2
    cfg.tracker.pose_iters = 2
    return cfg


def phase_config(phase, cfg_cls, cam_cls, rig):
    """The configuration of a phase for either package's config classes."""
    cfg = bench_config(cfg_cls, rig)
    if phase == "radtan":
        cfg.camera.dist = tuple(rig.dist)
        cfg.camera2 = None
        cfg.stereo.rectify = True
    elif phase == "kb8":
        cfg.camera = cam_cls(model="kannala_brandt8", fx=rig.fx, fy=rig.fy,
                             cx=rig.cx, cy=rig.cy, k=tuple(rig.k),
                             width=rig.width, height=rig.height)
        cfg.stereo.fisheye = True
    elif phase == "compact":
        cfg.map.max_kf = 24
        cfg.map.max_mp = 2048
        cfg.ba.max_points = 1024          # local BA's points must fit the slots
        cfg.tracker.min_frames_between_kf = 1
        cfg.tracker.kf_ref_ratio = 10.0
    elif phase == "fixed_window":
        cfg.mapping.covis_ba_window = False
    return cfg


def phase_rig(phase, rig_cls):
    if phase == "radtan":
        return rig_cls(dist=DIST)
    if phase == "kb8":
        return rig_cls(fx=285.0, fy=285.0, model="kannala_brandt8", k=KB8_K)
    return rig_cls()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=sorted(DEFAULT_FRAMES), required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--grey-start", type=int, default=GREY_START,
                    help="multimap: the first grey frame")
    ap.add_argument("--median-depth", action="store_true",
                    help="mono: scale the initial map to median depth 1")
    ap.add_argument("--corridor", action="store_true",
                    help="mono: tests/test_slam_modes.py's corridor (seed 5) "
                         "instead of the orbit")
    ap.add_argument("--imu-jolt", default=",".join(map(str, IMU_JOLT_V)),
                    help="imu: the velocity error (m/s, 'x,y,z') before IMU_JOLT_FRAME")
    args = ap.parse_args()
    n = args.frames or DEFAULT_FRAMES[args.phase]
    if args.phase == "imu":
        return imu(n, tuple(float(x) for x in args.imu_jolt.split(",")))
    if args.phase == "production":
        return production()
    if args.phase == "mono":
        return mono(n, args.median_depth, args.corridor)
    if args.phase == "rgbd":
        return rgbd(n)
    if args.phase == "multimap":
        return multimap(n, args.grey_start)

    import jax.numpy as jnp
    from orbslam3lib_tpu.config import CameraConfig, SlamConfig
    from orbslam3lib_tpu.tracking import tracker as jtr
    from orbslam3lib_tpu.utils import lie
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.io.synthetic import (StereoRig, orbit_pose_at,
                                                    render_orbit_sequence)

    t0 = time.time()
    rig = phase_rig(args.phase, StereoRig)
    imgs, ts, rig = render_orbit_sequence(n, rig)
    render_s = time.time() - t0
    frames = [(imgs[i], float(ts[i])) for i in range(n)]
    kidnap = args.phase == "pinhole" and n > KIDNAP_BACK
    if kidnap:
        dt = float(ts[1] - ts[0])
        frames += [(imgs[n - KIDNAP_BACK + i], float(ts[-1]) + (i + 1) * dt)
                   for i in range(3)]
    cfg = phase_config(args.phase, SlamConfig, CameraConfig, rig)
    tr = jtr.Tracker(cfg, "stereo", enable_loop_closing=True, pipeline=0)
    n_compact = [0]
    real_compact = tr._compact_map

    def counting_compact():
        ok = real_compact()
        n_compact[0] += int(ok)
        return ok

    tr._compact_map = counting_compact
    jolt = lie.so3_exp(jnp.asarray(JOLT_PRIOR[0], jnp.float32)), \
        jnp.asarray(JOLT_PRIOR[1], jnp.float32)
    loop_frame, results, kf_part = None, [], None
    t1 = time.time()
    for i, (img, stamp) in enumerate(frames):
        if args.phase == "pinhole" and i == JOLT_FRAME and i < n:
            tr.vel = jolt
        res = tr.process_frame(img, stamp)
        results.append(int(res["state"]))
        if loop_frame is None and tr.stats["n_loops"] > 0:
            loop_frame = i
        if i == n - 1:
            m = tr.map
            v = np.asarray(m.kf_valid)
            R, t = np.asarray(m.kf_R)[v], np.asarray(m.kf_t)[v]
            kts = np.asarray(m.kf_ts)[v].astype(np.float64) + tr._ts_origin
            est_kf = -np.einsum("kji,kj->ki", R, t)
            gt_kf = orbit_pose_at(kts, period=24.0, radius=0.5)[1]
            kf_part = {
                "kf_ate_m": ate_rmse(est_kf, gt_kf) if len(est_kf) >= 3 else None,
                "n_kf_alive": int(v.sum()), "map_n_kf": int(m.n_kf),
                "n_mp": int(m.n_mp),
                "loop_edges": [list(map(int, e)) for e in tr.loop_closer.loop_edges],
                "track_fail_before_kidnap": tr.stats["track_fail"],
                "traj": tr.trajectory_centers()[:n]}
    run_s = time.time() - t1
    traj = kf_part.pop("traj")
    t_traj = np.asarray([f[0] for f in tr.trajectory[:len(traj)]])
    gt = orbit_pose_at(t_traj, period=24.0, radius=0.5)[1]
    out = {"phase": args.phase, "frames": n, "render_s": round(render_s, 1),
           "run_s": round(run_s, 1),
           "ate_m": ate_rmse(traj, gt) if len(traj) >= 3 else None, **kf_part,
           "n_kf_created": tr.stats["n_kf"], "n_loops": tr.stats["n_loops"],
           "loop_frame": loop_frame, "track_fail": tr.stats["track_fail"],
           "n_reloc": tr.stats["n_reloc"], "state": int(tr.state),
           "states_ok": all(s == jtr.OK for s in results[:n]),
           "compactions": n_compact[0]}
    if kidnap:
        out["kidnap_states"] = results[n:]
    print(json.dumps(out), flush=True)
    return 0


def production() -> int:
    """Phase P: bench.py's full_slam protocol on the JAX reference."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_parity import InlineFetches
    from orbslam3lib_tpu.config import SlamConfig
    from orbslam3lib_tpu.mapping import map_ba as jmb
    from orbslam3lib_tpu.tracking import tracker as jtr
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.io.synthetic import (StereoRig, orbit_pose_at,
                                                    render_orbit_sequence)

    n = N_POPULATE + N_WARM + N_WINDOWS * N_WINDOW
    t0 = time.time()
    imgs, ts, rig = render_orbit_sequence(n, StereoRig())
    render_s = time.time() - t0
    # the GBA thread imports merge_gba_result when it merges: count them
    merges = [0]
    real_merge = jmb.merge_gba_result

    def counting_merge(*a, **k):
        merges[0] += 1
        return real_merge(*a, **k)

    jmb.merge_gba_result = counting_merge
    cfg = bench_config(SlamConfig, rig)
    cfg.mapping.async_gba = True
    tr = jtr.Tracker(cfg, "stereo", enable_loop_closing=True, pipeline=16, chunk=4,
                     async_mapping=True)
    tr._fetch_pool = InlineFetches()
    starts = [0]
    real_start = tr._maybe_start_gba

    def counting_start():
        before = tr._gba_thread
        real_start()
        starts[0] += int(tr._gba_thread is not None and tr._gba_thread is not before)

    tr._maybe_start_gba = counting_start
    t1 = time.time()
    kf_ratio = cfg.tracker.kf_ref_ratio
    cfg.tracker.kf_ref_ratio = 10.0
    cfg.tracker.min_frames_between_kf = 2
    cfg.tracker.max_frames_between_kf = 2
    cfg.mapping.kf_culling = False
    queue_save, tr._map_queue = tr._map_queue, None
    for i in range(N_POPULATE):
        tr.process_frame(imgs[i], float(ts[i]))
    tr.finish()
    tr._map_queue = queue_save
    populate = {"n_kf": int(tr.map.n_kf), "live_mp": int(np.asarray(tr.map.mp_valid).sum()),
                "fails": tr.stats["track_fail"], "s": round(time.time() - t1, 1)}
    cfg.tracker.kf_ref_ratio = kf_ratio
    cfg.tracker.min_frames_between_kf = 3
    cfg.tracker.max_frames_between_kf = 15
    cfg.mapping.kf_culling = True
    tr._compact_map()
    i = N_POPULATE
    for _ in range(N_WARM):
        tr.process_frame(imgs[i], float(ts[i]))
        i += 1
    tr._drain_pipeline()
    windows = []
    for _ in range(N_WINDOWS):
        fails = tr.stats["track_fail"]
        t2 = time.perf_counter()
        for _ in range(N_WINDOW):
            tr.process_frame(imgs[i], float(ts[i]))
            i += 1
        tr._drain_pipeline()
        windows.append({"ms_per_frame": round((time.perf_counter() - t2) / N_WINDOW * 1e3, 1),
                        "fails": tr.stats["track_fail"] - fails,
                        "n_kf": int(tr.map.n_kf), "n_loops": tr.stats["n_loops"]})
    tr.finish()
    run_s = time.time() - t1
    traj = tr.trajectory_centers()
    t_traj = np.asarray([f[0] for f in tr.trajectory])
    ate = ate_rmse(traj, orbit_pose_at(t_traj, period=24.0, radius=0.5)[1])
    m = tr.map
    v = np.asarray(m.kf_valid)
    R, t = np.asarray(m.kf_R)[v], np.asarray(m.kf_t)[v]
    kts = np.asarray(m.kf_ts)[v].astype(np.float64) + tr._ts_origin
    kf_ate = ate_rmse(-np.einsum("kji,kj->ki", R, t),
                      orbit_pose_at(kts, period=24.0, radius=0.5)[1])
    tr.shutdown_mapping()
    out = {"phase": "production", "frames": n, "render_s": round(render_s, 1),
           "run_s": round(run_s, 1), "populate": populate, "windows": windows,
           "ate_m": ate, "kf_ate_m": kf_ate, "n_kf_alive": int(v.sum()),
           "n_kf_created": tr.stats["n_kf"], "n_loops": tr.stats["n_loops"],
           "loop_edges": [list(map(int, e)) for e in tr.loop_closer.loop_edges],
           "track_fail": tr.stats["track_fail"], "state": int(tr.state),
           "trajectory_frames": len(traj), "gba_started": starts[0],
           "gba_merges": merges[0],
           "loop_latency_ms": tr.stats.get("loop_latency_ms")}
    print(json.dumps(out), flush=True)
    return 0


def grey_out(imgs, start: int, length: int):
    """Phase M's frames: a copy of the orbit with a window of flat grey."""
    out = imgs.copy()
    out[start:start + length] = 128
    return out


def multimap(n: int, grey_start: int) -> int:
    """Phase M on the JAX reference (see the module docstring)."""
    from orbslam3lib_tpu.config import SlamConfig
    from orbslam3lib_tpu.tracking import tracker as jtr
    from orbslam3lib_tpu_torch.evaluation import multimap_report
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, render_orbit_sequence

    t0 = time.time()
    imgs, ts, rig = render_orbit_sequence(n, StereoRig())
    imgs = grey_out(imgs, grey_start, GREY_LEN)
    render_s = time.time() - t0
    cfg = bench_config(SlamConfig, rig)
    tr = jtr.Tracker(cfg, "stereo", enable_loop_closing=True, pipeline=0)
    ev = {"spawn": None, "merge": None}
    origins = []
    frame = [0]
    real_spawn = tr._spawn_new_map

    def spawn_logged():
        ev["spawn"] = {"frame": frame[0], "n_kf_a": int(tr.map.n_kf),
                       "ts_origin_a": tr._ts_origin}
        real_spawn()

    tr._spawn_new_map = spawn_logged
    real_merge = tr.atlas.merge

    def merge_logged(src_idx, *a):
        src = tr.atlas.maps[src_idx]
        ev["merge"] = {"frame": frame[0], "n_kf_b_before": int(tr.atlas.current_map.n_kf),
                       "n_kf_a_valid": int(np.asarray(src.kf_valid).sum())}
        real_merge(src_idx, *a)

    tr.atlas.merge = merge_logged
    states, trajectory = [], []
    t1 = time.time()
    for i in range(n):
        frame[0] = i
        n_traj = len(tr.trajectory)
        states.append(int(tr.process_frame(imgs[i], float(ts[i]))["state"]))
        f = tr.trajectory[-1] if len(tr.trajectory) > n_traj else None
        trajectory.append(None if f is None else
                          (f[0], np.asarray(f[1], np.float64), np.asarray(f[2], np.float64)))
        if ev["merge"] is not None and "n_kf_after" not in ev["merge"]:
            ev["merge"]["n_kf_after"] = int(tr.map.n_kf)
    run_s = time.time() - t1
    m = tr.map
    if ev["merge"] is not None:
        nb = ev["merge"]["n_kf_b_before"]
        origins = [(0, tr._ts_origin), (nb, ev["spawn"]["ts_origin_a"]),
                   (nb + ev["merge"]["n_kf_a_valid"], tr._ts_origin)]
    else:
        origins = [(0, tr._ts_origin)]
    arrays = tuple(np.asarray(x) for x in (m.kf_valid, m.kf_R, m.kf_t, m.kf_ts))
    out = {"phase": "multimap", "frames": n, "grey": [grey_start, grey_start + GREY_LEN - 1],
           "render_s": round(render_s, 1), "run_s": round(run_s, 1),
           "spawn": ev["spawn"], "merge": ev["merge"],
           "n_new_maps": tr.stats["n_new_maps"], "n_map_merges": tr.stats["n_map_merges"],
           "n_maps_end": tr.atlas.count_maps(), "map_n_kf_end": int(m.n_kf),
           "n_kf_created": tr.stats["n_kf"], "n_loops": tr.stats["n_loops"],
           "track_fail": tr.stats["track_fail"], "state": int(tr.state),
           **multimap_report(arrays, origins, ev["spawn"], ev["merge"], trajectory,
                             states)}
    print(json.dumps(out), flush=True)
    return 0


def mono_frames(n: int, corridor: bool):
    """Phase O's left images, stamps and the analytic camera centre at a
    stamp: the orbit's, or tests/test_slam_modes.py's corridor (seed 5)."""
    from orbslam3lib_tpu_torch.io import synthetic as syn
    if corridor:
        frames, _, _ = syn.render_stereo_sequence(n, syn.StereoRig(), seed=5)
        imgs = np.stack([f[0][0] for f in frames])
        ts = np.array([f[2] for f in frames])
        return imgs, ts, lambda t: syn.corridor_pose_at(t)[1]
    imgs, ts, _ = syn.render_orbit_sequence(n, syn.StereoRig())
    return imgs[:, 0], ts, lambda t: syn.orbit_pose_at(t, period=24.0, radius=0.5)[1]


def mono(n: int, median_depth: bool, corridor: bool) -> int:
    """Phase O on the JAX reference (see the module docstring)."""
    import jax.numpy as jnp
    from orbslam3lib_tpu.config import SlamConfig
    from orbslam3lib_tpu.tracking import reloc as jreloc
    from orbslam3lib_tpu.utils import lie
    from orbslam3lib_tpu.mapping import loop_closing as jlc
    from orbslam3lib_tpu.tracking import tracker as jtr
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig

    t0 = time.time()
    imgs, ts, centre_at = mono_frames(n, corridor)
    render_s = time.time() - t0
    cfg = bench_config(SlamConfig, StereoRig())
    inits, loops = [], []
    real_init = jtr._mono_init_map

    def init_logged(m, *a, **k):
        tri_ok, t21, p3d = np.asarray(a[13]), a[15], a[16]
        z = np.asarray(p3d)[:, 2][tri_ok]
        med = float(np.sort(z)[(len(z) - 1) // 2]) if len(z) else 1.0
        inits.append({"n_tri": int(tri_ok.sum()), "median_depth": med,
                      "t21_norm": float(np.linalg.norm(np.asarray(t21)))})
        if median_depth:
            a = list(a)
            a[15], a[16] = t21 / med, p3d / med
        return real_init(m, *a, **k)

    real_correct = jlc.LoopCloser.correct

    def correct_logged(self, m, kf_cur, kf_loop, S12):
        loops.append({"frame": frame[0], "kf": [int(kf_loop), int(kf_cur)],
                      "s": float(np.asarray(S12[2]))})
        return real_correct(self, m, kf_cur, kf_loop, S12)

    jtr._mono_init_map = init_logged
    jlc.LoopCloser.correct = correct_logged
    tr = jtr.Tracker(cfg, "mono", enable_loop_closing=True, pipeline=0)
    frame = [0]
    states, init_frame = [], None
    jolt = lie.so3_exp(jnp.asarray(JOLT_PRIOR[0], jnp.float32)), \
        jnp.asarray(JOLT_PRIOR[1], jnp.float32)
    fallbacks = [0]
    real_ref = jreloc.track_reference_kf

    def ref_counted(*a, **k):
        fallbacks[0] += 1
        return real_ref(*a, **k)

    jreloc.track_reference_kf = ref_counted
    t1 = time.time()
    for i in range(n):
        frame[0] = i
        if i == MONO_JOLT_FRAME and n <= DEFAULT_FRAMES["mono"]:
            tr.vel = jolt
        states.append(int(tr.process_frame(imgs[i], float(ts[i]))["state"]))
        if init_frame is None and states[-1] == jtr.OK:
            init_frame = i
    run_s = time.time() - t1
    traj = tr.trajectory_centers()
    gt = centre_at(np.asarray([f[0] for f in tr.trajectory]))
    m = tr.map
    v = np.asarray(m.kf_valid)
    out = {"phase": "mono", "frames": n, "median_depth_fix": median_depth,
           "sequence": "corridor" if corridor else "orbit",
           "render_s": round(render_s, 1), "run_s": round(run_s, 1),
           "init_frame": init_frame, "inits": inits,
           "ate_sim3_m": ate_rmse(traj, gt, with_scale=True) if len(traj) >= 3 else None,
           "trajectory_frames": len(traj), "n_kf_created": tr.stats["n_kf"],
           "n_kf_alive": int(v.sum()), "n_mp": int(m.n_mp),
           "n_loops": tr.stats["n_loops"], "loops": loops,
           "loop_edges": [list(map(int, e)) for e in tr.loop_closer.loop_edges],
           "track_fail": tr.stats["track_fail"], "n_reloc": tr.stats["n_reloc"],
           "ref_kf_fallbacks": fallbacks[0],
           "n_resets": tr.stats["n_resets"], "n_new_maps": tr.stats["n_new_maps"],
           "state": int(tr.state),
           "first_fail": next((i for i, s in enumerate(states)
                               if init_frame is not None and i > init_frame and s != jtr.OK),
                              None)}
    print(json.dumps(out), flush=True)
    return 0


def rgbd(n: int) -> int:
    """Phase R on the JAX reference (see the module docstring)."""
    import jax.numpy as jnp
    from orbslam3lib_tpu import system as jsys
    from orbslam3lib_tpu.utils import lie
    from orbslam3lib_tpu.config import SlamConfig
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.io.synthetic import (StereoRig, orbit_depth_maps,
                                                    orbit_pose_at, render_orbit_sequence)

    t0 = time.time()
    imgs, ts, rig = render_orbit_sequence(n, StereoRig())
    depths = orbit_depth_maps(n, rig)
    render_s = time.time() - t0
    cfg = bench_config(SlamConfig, rig)
    s = jsys.System(cfg, jsys.SENSOR_RGBD, enable_loop_closing=True)
    tr = s.tracker
    states = []
    jolt = lie.so3_exp(jnp.asarray(JOLT_PRIOR[0], jnp.float32)), \
        jnp.asarray(JOLT_PRIOR[1], jnp.float32)
    t1 = time.time()
    for i in range(n):
        if i == RGBD_JOLT_FRAME:
            tr.vel = jolt
        states.append(int(s.track_rgbd(imgs[i, 0], depths[i], float(ts[i]))["state"]))
    run_s = time.time() - t1
    traj = tr.trajectory_centers()
    t_traj = np.asarray([f[0] for f in tr.trajectory])
    gt = orbit_pose_at(t_traj, period=24.0, radius=0.5)[1]
    m = tr.map
    v = np.asarray(m.kf_valid)
    R, t = np.asarray(m.kf_R)[v], np.asarray(m.kf_t)[v]
    kts = np.asarray(m.kf_ts)[v].astype(np.float64) + tr._ts_origin
    kf_ate = ate_rmse(-np.einsum("kji,kj->ki", R, t),
                      orbit_pose_at(kts, period=24.0, radius=0.5)[1])
    s.shutdown()
    out = {"phase": "rgbd", "frames": n, "render_s": round(render_s, 1),
           "run_s": round(run_s, 1), "ate_m": ate_rmse(traj, gt), "kf_ate_m": kf_ate,
           "trajectory_frames": len(traj), "n_kf_created": tr.stats["n_kf"],
           "n_kf_alive": int(v.sum()), "n_mp": int(m.n_mp),
           "n_loops": tr.stats["n_loops"], "track_fail": tr.stats["track_fail"],
           "state": int(tr.state), "states_ok": all(x == 1 for x in states)}
    print(json.dumps(out), flush=True)
    return 0


def imu_sequence(n: int, imu_cfg):
    """Phase I's frames (f32 stereo pairs, the grey window applied), stamps
    and IMU stream (`io.synthetic.corridor_imu_stream`)."""
    from orbslam3lib_tpu_torch.io import synthetic as syn
    frames, _, _ = syn.render_stereo_sequence(n, syn.StereoRig(), seed=5)
    imgs = np.stack([f[0] for f in frames])
    imgs[IMU_GREY[0]:IMU_GREY[0] + IMU_GREY[1]] = 128.0
    ts = np.array([f[2] for f in frames])
    imu = syn.corridor_imu_stream(ts, imu_cfg.noise_gyro, imu_cfg.noise_acc, imu_cfg.freq,
                                  bg=IMU_BG, ba=IMU_BA, seed=0)
    return imgs, ts, imu


def imu(n: int, jolt_v) -> int:
    """Phase I on the JAX reference (see the module docstring)."""
    import jax.numpy as jnp
    from orbslam3lib_tpu import system as jsys
    from orbslam3lib_tpu.config import SlamConfig
    from orbslam3lib_tpu.tracking import reloc as jreloc
    from orbslam3lib_tpu_torch.evaluation import imu_report
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig

    cfg = bench_config(SlamConfig, StereoRig())
    t0 = time.time()
    imgs, ts, imu_data = imu_sequence(n, cfg.imu)
    render_s = time.time() - t0
    s = jsys.System(cfg, jsys.SENSOR_IMU_STEREO, enable_loop_closing=True)
    tr = s.tracker
    fallbacks = []
    real_ref = jreloc.track_reference_kf
    frame = [0]

    def ref_counted(*a, **k):
        fallbacks.append(frame[0])
        return real_ref(*a, **k)

    jreloc.track_reference_kf = ref_counted
    ev = {"imu_init_frame": None, "viba1_frame": None, "viba2_frame": None}
    states, biases = [], []
    t1 = time.time()
    for i in range(n):
        frame[0] = i
        if i == IMU_JOLT_FRAME:
            tr.frame_state_v = tr.frame_state_v + jnp.asarray(jolt_v, jnp.float32)
        states.append(int(s.track_stereo(imgs[i], float(ts[i]), imu=imu_data[i])["state"]))
        biases.append(np.concatenate([np.asarray(x, np.float64) for x in tr.imu_bias]))
        if ev["imu_init_frame"] is None and tr.imu_ready:
            ev["imu_init_frame"] = i
        if ev["viba1_frame"] is None and tr._viba_stage >= 1:
            ev["viba1_frame"] = i
        if ev["viba2_frame"] is None and tr._viba_stage >= 2:
            ev["viba2_frame"] = i
    run_s = time.time() - t1
    m = tr.map
    arrays = tuple(np.asarray(x) for x in (m.kf_valid, m.kf_R, m.kf_t, m.kf_ts))
    grey_ts = ts[IMU_GREY[0]:IMU_GREY[0] + IMU_GREY[1]]
    bg, ba = (np.asarray(x, np.float64).tolist() for x in tr.imu_bias)
    last_kf = int(np.flatnonzero(arrays[0])[-1])
    tail = np.asarray(biases[-30:])
    out = {"phase": "imu", "frames": n, "jolt_v": list(jolt_v), "grey": list(IMU_GREY),
           "render_s": round(render_s, 1), "run_s": round(run_s, 1), **ev,
           "track_fail": tr.stats["track_fail"],
           "fail_frames": [i for i, x in enumerate(states) if x != jsys.OK],
           "n_kf_created": tr.stats["n_kf"], "n_kf_alive": int(arrays[0].sum()),
           "n_reloc": tr.stats["n_reloc"], "n_loops": tr.stats["n_loops"],
           "n_resets": tr.stats["n_resets"], "n_new_maps": tr.stats["n_new_maps"],
           "ref_kf_fallback_frames": fallbacks, "state": int(tr.state),
           "bias_g": bg, "bias_a": ba,
           "last_kf_bias_g": np.asarray(m.kf_bg)[last_kf].tolist(),
           "last_kf_bias_a": np.asarray(m.kf_ba)[last_kf].tolist(),
           "bias_last30_min": tail.min(0).round(6).tolist(),
           "bias_last30_max": tail.max(0).round(6).tolist(),
           **imu_report(tr.trajectory, arrays, tr._ts_origin, grey_ts,
                        (np.asarray(m.kf_bg), np.asarray(m.kf_ba)), tr._imu_init_ts)}
    s.shutdown()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
