#!/usr/bin/env python3
"""How the monocular-inertial initialisation's scale estimate falls with
noise in the keyframe positions, on analytic keyframes (the port's
`inertial_init_optimization`, the reference's arithmetic; ~5 min on two CPU
threads).

    python3 tools/imu_mono_scale.py [--grid 0.8,0.25 1.5,1.0 2.0,1.2 3.0,1.2]
        [--keyframes 7,12,20] [--sigma 0,0.002,0.005,0.01] [--trials 3]

For each corridor setting (speed m/s, sway m of `io.synthetic.
corridor_pose_at`), window of K keyframes 0.25 s apart (the monocular
tracker's keyframe gap before the IMU is initialised) and position noise
sigma (m, Gaussian, per keyframe and axis), the analytic camera poses are
put in the first camera's frame and divided by a true scale of 3 (a map at
median depth 1 of a corridor ~3 m deep), and the IMU between them is
`corridor_imu_stream` with cfg.imu's noise and chip_smoke's constant
biases. Prints the estimated scale over the true one for `--trials`
noise draws. The estimator takes each velocity from the difference of two
keyframe positions (`closed_form_velocities`), so position noise enters
the velocity residuals divided by the 0.25 s gap and pulls the scale
towards 0 unless the acceleration is large against it.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

S_TRUE = 3.0
GAP_S = 0.25
IMU_BG = (0.002, -0.001, 0.0015)
IMU_BA = (0.02, -0.01, 0.015)


def scale_ratio(speed: float, wiggle: float, K: int, sigma: float, seed: int) -> float:
    from orbslam3lib_tpu_torch.config import ImuConfig
    from orbslam3lib_tpu_torch.io import synthetic as syn
    from orbslam3lib_tpu_torch.tracking import imu as imu_mod
    from orbslam3lib_tpu_torch.tracking.inertial_opt import inertial_init_optimization
    ci = ImuConfig()
    ts = np.arange(K) * GAP_S
    R_cw, c = syn.corridor_pose_at(ts, speed, wiggle)
    R_map = np.einsum("ji,kjl->kil", R_cw[0], R_cw)          # camera k in camera 0
    c_map = (c - c[0]) @ R_cw[0]
    rng = np.random.default_rng(seed)
    c_map = (c_map + rng.normal(0, sigma, c_map.shape)) / S_TRUE
    kf_R = np.ascontiguousarray(np.transpose(R_map, (0, 2, 1))).astype(np.float32)
    kf_t = -np.einsum("kij,kj->ki", kf_R, c_map).astype(np.float32)
    stream = syn.corridor_imu_stream(ts, ci.noise_gyro, ci.noise_acc, ci.freq, bg=IMU_BG,
                                     ba=IMU_BA, seed=seed, speed=speed, wiggle=wiggle)
    sg, sa = ci.noise_gyro * np.sqrt(ci.freq), ci.noise_acc * np.sqrt(ci.freq)
    pres = imu_mod.Preintegrated.stack([
        imu_mod.integrate(imu_mod.empty_preintegrated(), *stream[k], sg, sa)
        for k in range(1, K)])
    out = inertial_init_optimization(
        torch.from_numpy(kf_R), torch.from_numpy(kf_t), torch.ones(K, dtype=torch.bool),
        pres, torch.ones(K - 1, dtype=torch.bool), opt_scale=True)
    return float(out[3]) / S_TRUE


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", nargs="+", default=["0.8,0.25", "1.5,1.0", "2.0,1.2", "3.0,1.2"])
    ap.add_argument("--keyframes", default="7,12,20")
    ap.add_argument("--sigma", default="0,0.002,0.005,0.01")
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()
    torch.set_num_threads(2)
    sigmas = [float(x) for x in args.sigma.split(",")]
    print("speed wiggle K | estimated / true scale at sigma " + ", ".join(map(str, sigmas)))
    for item in args.grid:
        speed, wiggle = (float(x) for x in item.split(","))
        for K in (int(k) for k in args.keyframes.split(",")):
            cells = [" ".join(f"{scale_ratio(speed, wiggle, K, sg, t):.3f}"
                              for t in range(args.trials)) for sg in sigmas]
            print(f"{speed} {wiggle} {K} | " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
