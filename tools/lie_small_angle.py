#!/usr/bin/env python3
"""How far the port's f32 Lie maps' forward-mode Jacobians lie from f64,
by rotation angle, under three arithmetics of the small-angle
coefficients: the reference's (series only below theta^2 = 1e-8, `_sim3_W`
in f32), the port's (series below `lie._SERIES_THETA2`, `_sim3_W`'s
coefficients in f64), and the closed forms everywhere.

    python3 tools/lie_small_angle.py [--device cpu|cuda] [--n 64]

For each theta it draws `--n` tangents (seeded) with a rotation part of that
norm and a translation part of norm ~0.5, and prints per map the largest
|J_f32 - J_f64| over the batch: `se3_exp` (R and t), `so3_exp`, `se3_log`
at exp(xi), and `sim3_exp` (its t) at sigma = 0 and 0.01, and `sim3_log` at
exp(xi, sigma = 0.003). The f64 Jacobian uses the port's arithmetic (in
f64 every form is exact to ~1e-8 there).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from orbslam3lib_tpu_torch.utils import lie  # noqa: E402

THETAS = (1e-6, 1e-5, 1e-4, 2.5e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.2, 0.3)
MAPS = {
    "se3_exp": lambda v: torch.cat([lie.se3_exp(v)[0].flatten(-2), lie.se3_exp(v)[1]], -1),
    "so3_exp": lambda v: lie.so3_exp(v[..., 3:]).flatten(-2),
    "se3_log": lambda v: lie.se3_log(*lie.se3_exp(v)),
    "sim3_exp": lambda v: lie.sim3_exp(_sigma(v, 0.01))[1],
    "sim3_exp_s0": lambda v: lie.sim3_exp(_sigma(v, 0.0))[1],
    "sim3_log": lambda v: lie.sim3_log(*lie.sim3_exp(_sigma(v, 0.003))),
}


def _sigma(v: torch.Tensor, sigma: float) -> torch.Tensor:
    return torch.cat([v, torch.full_like(v[..., :1], sigma)], -1)


def tangents(theta: float, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    rho = rng.normal(size=(n, 3))
    rho *= 0.5 / np.linalg.norm(rho, axis=1, keepdims=True)
    return np.concatenate([rho, theta * ax], axis=1)


def jac(f, x: torch.Tensor) -> torch.Tensor:
    return lie.value_and_rowwise_jacobian(f, x)[1]


def _set(arith) -> None:
    lie._SERIES_THETA2, lie._SIM3_W_DTYPE = arith


def measure(device: str, n: int, ariths) -> list:
    rows = []
    port = (lie._SERIES_THETA2, lie._SIM3_W_DTYPE)
    try:
        for theta in THETAS:
            x = tangents(theta, n)
            row = {"theta": theta}
            for name, f in MAPS.items():
                _set(port)
                J64 = jac(f, torch.as_tensor(x, dtype=torch.float64, device=device))
                for label, arith in ariths.items():
                    _set(arith)
                    J32 = jac(f, torch.as_tensor(x, dtype=torch.float32, device=device))
                    row[f"{name}:{label}"] = float((J32.double() - J64).abs().max())
            rows.append(row)
    finally:
        _set(port)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--n", type=int, default=64)
    args = ap.parse_args()
    ariths = {"reference": (lie._EPS, None),
              "port": (lie._SERIES_THETA2, lie._SIM3_W_DTYPE),
              "closed": (0.0, None)}
    print(json.dumps({"device": args.device, "port_series_theta2": lie._SERIES_THETA2}))
    for row in measure(args.device, args.n, ariths):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
