"""Camera models (port of `orbslam3lib_tpu/utils/cameras.py`): pinhole and
pinhole with radial-tangential distortion (PINHOLE_RADTAN), as batched pure
functions of a flat parameter vector.

Parameter layouts (float32 tensors):
  PINHOLE:         [fx, fy, cx, cy]
  PINHOLE_RADTAN:  [fx, fy, cx, cy, k1, k2, p1, p2, k3]

Each function keeps the reference's operation order, so the f32 values
agree to a few ulps; the radial-tangential inverse runs the reference's 8
fixed-point steps.
"""
from __future__ import annotations

import torch

PINHOLE = 0
PINHOLE_RADTAN = 2

_EPS = 1e-9


def _safe_inv(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < _EPS, torch.full_like(x, _EPS), x)


def pinhole_project(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    inv_z = _safe_inv(p3d[..., 2])
    u = fx * p3d[..., 0] * inv_z + cx
    v = fy * p3d[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def pinhole_project_jac(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(p3d): (..., 2, 3) (reference Pinhole::projectJac)."""
    fx, fy = params[0], params[1]
    x, y = p3d[..., 0], p3d[..., 1]
    inv_z = _safe_inv(p3d[..., 2])
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(x)
    row0 = torch.stack([fx * inv_z, zeros, -fx * x * inv_z2], dim=-1)
    row1 = torch.stack([zeros, fy * inv_z, -fy * y * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


# -- pinhole + radial-tangential distortion (reference :77-149) -------------

def _radtan_distort(k: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Radial-tangential distortion of normalised coordinates."""
    k1, k2, p1, p2, k3 = k[0], k[1], k[2], k[3], k[4]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def radtan_project(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) distorted pixels."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    inv_z = _safe_inv(p3d[..., 2])
    x = p3d[..., 0] * inv_z
    y = p3d[..., 1] * inv_z
    xd, yd = _radtan_distort(params[4:9], x, y)
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def radtan_unproject(params: torch.Tensor, uv: torch.Tensor,
                     n_iter: int = 8) -> torch.Tensor:
    """Distorted pixels -> z = 1 rays by the cv::undistortPoints fixed point
    x = (xd - dx(x)) / radial(x), n_iter steps."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(n_iter):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / _nonzero(radial)
        x, y = (xd - dx) * inv, (yd - dy) * inv
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def radtan_project_jac(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(p3d): (..., 2, 3), closed form through the distortion."""
    fx, fy = params[0], params[1]
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    X, Y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    inv_z = _safe_inv(z)
    x = X * inv_z
    y = Y * inv_z
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dradial = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)   # d(radial)/d(r2)
    dxd_dx = radial + x * dradial * 2.0 * x + 2.0 * p1 * y + 6.0 * p2 * x
    dxd_dy = x * dradial * 2.0 * y + 2.0 * p1 * x + 2.0 * p2 * y
    dyd_dx = y * dradial * 2.0 * x + 2.0 * p1 * x + 2.0 * p2 * y
    dyd_dy = radial + y * dradial * 2.0 * y + 6.0 * p1 * y + 2.0 * p2 * x
    inv_z2 = inv_z * inv_z
    du_dX = fx * dxd_dx * inv_z
    du_dY = fx * dxd_dy * inv_z
    du_dz = fx * (dxd_dx * (-X * inv_z2) + dxd_dy * (-Y * inv_z2))
    dv_dX = fy * dyd_dx * inv_z
    dv_dY = fy * dyd_dy * inv_z
    dv_dz = fy * (dyd_dx * (-X * inv_z2) + dyd_dy * (-Y * inv_z2))
    row0 = torch.stack([du_dX, du_dY, du_dz], dim=-1)
    row1 = torch.stack([dv_dX, dv_dY, dv_dz], dim=-1)
    return torch.stack([row0, row1], dim=-2)


# -- dispatch on the model id (a Python int) --------------------------------

def project(model: int, params, p3d):
    if model == PINHOLE:
        return pinhole_project(params, p3d)
    if model == PINHOLE_RADTAN:
        return radtan_project(params, p3d)
    raise ValueError(f"camera model {model}: the reference has pinhole and radial-tangential")


def project_jac(model: int, params, p3d):
    if model == PINHOLE:
        return pinhole_project_jac(params, p3d)
    if model == PINHOLE_RADTAN:
        return radtan_project_jac(params, p3d)
    raise ValueError(f"camera model {model}: the reference has pinhole and radial-tangential")
