"""IMU preintegration of one frame's samples (Forster et al., on-manifold
preintegration; ORB-SLAM3's IntegrateNewMeasurement): the rotation, velocity
and position increments dR, dV, dP from the bias-corrected samples, position
and velocity first with the rotation from before the step. Plain torch in
the dtype and on the device given (float64 on the host for the reference)."""
from __future__ import annotations

import torch


def _exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula for one rotation vector (3,)."""
    th = torch.linalg.norm(w)
    K = torch.zeros(3, 3, dtype=w.dtype, device=w.device)
    K[0, 1], K[0, 2], K[1, 2] = -w[2], w[1], -w[0]
    K = K - K.T
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(th) < 1e-8:
        return eye + K + 0.5 * K @ K
    return eye + torch.sin(th) / th * K + (1 - torch.cos(th)) / (th * th) * K @ K


def preintegrate(gyro, acc, dts, bg, ba, dtype=torch.float64, device="cpu"):
    """(dR (3, 3), dV (3,), dP (3,)) over the samples (N, 3), (N, 3), (N,)
    with the biases bg, ba held fixed."""
    f = dict(dtype=dtype, device=device)
    g = torch.as_tensor(gyro, **f) - torch.as_tensor(bg, **f)
    a = torch.as_tensor(acc, **f) - torch.as_tensor(ba, **f)
    d = torch.as_tensor(dts, **f)
    dR = torch.eye(3, **f)
    dV = torch.zeros(3, **f)
    dP = torch.zeros(3, **f)
    for k in range(d.shape[0]):
        acc_w = dR @ a[k]
        dP = dP + dV * d[k] + 0.5 * acc_w * d[k] * d[k]
        dV = dV + acc_w * d[k]
        dR = dR @ _exp(g[k] * d[k])
    return dR, dV, dP
