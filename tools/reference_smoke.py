#!/usr/bin/env python3
"""The JAX reference's synchronous tracker at the configurations of
`chip_smoke.py`'s phases, on the CPU: the numbers the smoke's bounds come
from. Needs JAX (it runs where the reference runs, not on the card's
machine).

    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase pinhole
    JAX_PLATFORMS=cpu python3 tools/reference_smoke.py --phase radtan --frames 400

Phases (frames rendered by the port's numpy renderer, the same frames the
smoke feeds the port; bench.py's configuration: 640x400, 512 keypoints, 8
levels, 2x2 pose iterations, loop closing on, `pipeline=0`):
  pinhole  the room orbit, 400 frames, the wrong motion prior before frame
           370 and the kidnap (frame 220's image and two more after the
           last frame), as chip_smoke's slice phase;
  radtan   phase D: raw radial-tangential stereo (bench.py's DIST),
           `cfg.stereo.rectify`;
  kb8      phase F: two-camera Kannala-Brandt stereo, `cfg.stereo.fisheye`;
  compact  phase C: the first 150 pinhole frames with 24 KF / 2048 MP
           slots, 1024 local-BA points and dense keyframing
           (tests/test_compaction.py::test_long_sequence_with_recycling).
Prints one JSON line per phase: trajectory and keyframe ATE (m, SE(3)
aligned to the analytic orbit), keyframes, loops and their pairs, the loop
frame, failures and (compact) compactions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
KB8_K = (0.02, -0.01, 0.003, 0.0)
DEFAULT_FRAMES = {"pinhole": 400, "radtan": 400, "kb8": 180, "compact": 150}
JOLT_FRAME = 370
JOLT_PRIOR = ((0.0, 0.2, 0.0), (0.3, 0.0, 0.0))
KIDNAP_BACK = 180


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
    args = ap.parse_args()
    n = args.frames or DEFAULT_FRAMES[args.phase]

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


if __name__ == "__main__":
    sys.exit(main())
