"""Camera models (port of `orbslam3lib_tpu/utils/cameras.py:22-60, 236-264`).

The stereo slice runs on rectified pinhole images, so only PINHOLE is ported
here; the radial-tangential and Kannala-Brandt models keep their ids (the
config refers to them) and raise until they are ported.

Parameter layout: [fx, fy, cx, cy] (float32 tensor).
"""
from __future__ import annotations

import torch

PINHOLE = 0
KANNALA_BRANDT = 1
PINHOLE_RADTAN = 2

_EPS = 1e-9


def _safe_inv(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)


def pinhole_project(params: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    inv_z = _safe_inv(p3d[..., 2])
    u = fx * p3d[..., 0] * inv_z + cx
    v = fy * p3d[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels -> (..., 3) unit-depth rays (z = 1)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


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


def _only_pinhole(model: int) -> None:
    if model != PINHOLE:
        raise NotImplementedError(
            f"camera model {model} is not ported yet (PINHOLE only)")


def project(model: int, params, p3d):
    _only_pinhole(model)
    return pinhole_project(params, p3d)


def unproject(model: int, params, uv):
    _only_pinhole(model)
    return pinhole_unproject(params, uv)


def project_jac(model: int, params, p3d):
    _only_pinhole(model)
    return pinhole_project_jac(params, p3d)
