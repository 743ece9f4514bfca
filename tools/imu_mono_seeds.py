#!/usr/bin/env python3
"""chip_smoke.py's phase J on the port over several seeds of its two-view
RANSAC draws: how far the run's events move with the draws alone.

    python3 tools/imu_mono_seeds.py [--seeds 0,1,2] [--device cpu|cuda]
        [--frames N_IMU_MONO] [--threads 2]

For each seed runs `System(cfg, "imu_mono", device=...)` over phase J's
left images and IMU (`chip_smoke.render_imu_mono`: the seed-5 corridor at
IMU_MONO_SPEED with a sway of IMU_MONO_WIGGLE), `reconstruct_two_views`
drawing with that seed, and prints one JSON line per seed, with the keys of
`tools/reference_smoke.py --phase imu_mono`: the map's and the IMU's
initialisation frames, every initialisation attempt (frame, keyframes,
scale), VIBA1 / VIBA2, the scale refinements, the failures and new maps,
the keyframes and `evaluation.imu_mono_report`. About 1.5 min a seed on an
NVIDIA H100 80GB HBM3 at 700 W; 20 min a seed of 450 frames on two CPU
threads, ~3 GB.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    import chip_smoke as cs
    from orbslam3lib_tpu_torch.evaluation import imu_mono_report
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, orbit_tracking_config
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking import tracker as ttr

    n = args.frames or cs.N_IMU_MONO
    imgs, ts, imu, _ = cs.render_imu_mono(n)
    reconstruct = ttr.reconstruct_two_views
    real_solve = ttr.inertial_init_optimization
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        ttr.reconstruct_two_views = lambda *a, seed=seed, **k: reconstruct(*a, seed=seed, **k)
        s = System(orbit_tracking_config(StereoRig()), "imu_mono", device=dev)
        tr = s.tracker
        frame, solves = [0], []

        def solve_logged(kf_R, *a, **k):
            out = real_solve(kf_R, *a, **k)
            solves.append({"frame": frame[0], "n_kf": int(kf_R.shape[0]), "s": float(out[3]),
                           "ready": bool(tr.imu_ready), "n_kf_made": tr.stats["n_kf"]})
            return out

        ttr.inertial_init_optimization = solve_logged
        ev = {"map_init_frame": None, "imu_init_frame": None, "viba1_frame": None,
              "viba2_frame": None}
        states = []
        for i in range(n):
            frame[0] = i
            states.append(int(s.track_monocular(imgs[i], float(ts[i]), imu=imu[i])["state"]))
            for key, hit in (("map_init_frame", states[-1] == 1), ("imu_init_frame", tr.imu_ready),
                             ("viba1_frame", tr._viba_stage >= 1),
                             ("viba2_frame", tr._viba_stage >= 2)):
                if ev[key] is None and hit:
                    ev[key] = i
        ttr.inertial_init_optimization = real_solve
        st = s.get_stats()
        m = tr.map
        arrays = tuple(x.cpu().numpy() for x in (m.kf_valid, m.kf_R, m.kf_t, m.kf_ts))
        rep = imu_mono_report(tr.trajectory, arrays, tr._ts_origin, tr._imu_init_ts,
                              (m.kf_bg.cpu().numpy(), m.kf_ba.cpu().numpy()),
                              cs.IMU_MONO_SPEED, cs.IMU_MONO_WIGGLE)
        s.shutdown()
        init = ev["map_init_frame"]
        attempts = [x for x in solves if not x["ready"]]
        print(json.dumps({
            "seed": seed, "device": str(dev), "frames": n, **ev,
            "init_attempts": [(x["frame"], x["n_kf"], x["n_kf_made"], round(x["s"], 6))
                              for x in attempts],
            "imu_init_kf": next((x["n_kf_made"] for x in attempts if x["s"] >= 0.1), None),
            "scale_refinements": [(x["frame"], round(x["s"], 6)) for x in solves if x["ready"]],
            "fail_frames": [i for i, x in enumerate(states)
                            if x != 1 and init is not None and i > init],
            "n_kf_created": st["n_kf"], "n_resets": st["n_resets"],
            "n_new_maps": st["n_new_maps"], "ref_kf_fallbacks": st["ref_kf_fallbacks"],
            "state": states[-1], **rep}, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
