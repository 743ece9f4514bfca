"""Body-frame IMU samples along a trajectory: a vectorised numpy copy of the
port's `synth_imu` / `corridor_imu_stream` (`io/synthetic.py`).

The IMU is the camera (identity extrinsic). At `freq` Hz, each sample's body
rate and acceleration come from central finite differences of the analytic
pose around the sample's midpoint; the accelerometer measures the specific
force f = R_wb^T (a_w - g_w), with g_w = (0, 9.81, 0) (+y down). Constant
biases and white noise at the discrete sigmas (density times sqrt(freq))
are added, the noise drawn from `default_rng(seed)`.
"""
from __future__ import annotations

import numpy as np

from .world import pose_at

GRAVITY_W = np.array([0.0, 9.81, 0.0])
FD_EPS = 1e-4


def imu_samples(traj: dict, t_end: float, freq: float, noise_gyro: float,
                noise_acc: float, bg, ba, seed: int):
    """Samples at k / freq for k = 1 .. floor(t_end * freq): (times (N,)
    float64, gyro (N, 3), acc (N, 3)) float32."""
    dt = 1.0 / freq
    n = int(np.floor(t_end * freq + 1e-9))
    ts = np.arange(1, n + 1, dtype=np.float64) * dt
    mid = ts - 0.5 * dt
    R0, p_m = pose_at(traj, mid)
    Ra, p_lo = pose_at(traj, mid - FD_EPS)
    Rb, p_hi = pose_at(traj, mid + FD_EPS)
    a_w = (p_hi - 2.0 * p_m + p_lo) / (FD_EPS * FD_EPS)
    dRm = np.einsum("tji,tjk->tik", Ra, Rb)
    w_hat = (dRm - np.transpose(dRm, (0, 2, 1))) / (4.0 * FD_EPS)
    gyro = np.stack([w_hat[:, 2, 1], w_hat[:, 0, 2], w_hat[:, 1, 0]], axis=-1)
    f_b = np.einsum("tji,tj->ti", R0, a_w - GRAVITY_W)
    rng = np.random.default_rng(seed)
    gyro = gyro + np.asarray(bg, np.float64) + rng.normal(0, noise_gyro * np.sqrt(freq), gyro.shape)
    f_b = f_b + np.asarray(ba, np.float64) + rng.normal(0, noise_acc * np.sqrt(freq), f_b.shape)
    return ts, gyro.astype(np.float32), f_b.astype(np.float32)


def per_frame(frame_ts: np.ndarray, imu_ts: np.ndarray, gyro, acc, freq: float):
    """Split the samples between frames: frame i gets those in
    (frame_ts[i-1], frame_ts[i]] as (gyro, acc, dts); frame 0 gets None."""
    dt = np.float32(1.0 / freq)
    bounds = np.searchsorted(imu_ts, np.asarray(frame_ts) + 1e-9, side="right")
    out = [None]
    for i in range(1, len(frame_ts)):
        s, e = bounds[i - 1], bounds[i]
        out.append((gyro[s:e], acc[s:e], np.full(e - s, dt, np.float32)))
    return out
