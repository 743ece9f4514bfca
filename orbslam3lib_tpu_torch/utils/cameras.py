"""Camera models (port of `orbslam3lib_tpu/utils/cameras.py:22-60, 236-264`)
and the mapper's two-view triangulation (`cameras.py:292-331`).

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


def triangulate_two_view(ray1, ray2, R12, t12):
    """Triangulate in camera 1's frame given the pose of camera 2 in camera 1
    (x_1 = R12 x_2 + t12). ray1/ray2: (..., 3) bearings in each camera.
    Returns (p3d_c1, parallax_cos, z1, z2).

    Closed-form midpoint of the closest approach of the two unit rays, from
    the 2x2 Gram system. Its denominator 1 - cos^2 = sin^2 is computed as
    |r1 x r2|^2: the direct form cancels catastrophically for the near-
    parallel rays of neighbour keyframes centimetres apart, which is where
    the mapper triangulates.
    """
    r1 = ray1 / torch.linalg.norm(ray1, dim=-1, keepdim=True)
    r2w = torch.einsum("...ij,...j->...i", R12, ray2)
    r2w = r2w / torch.linalg.norm(r2w, dim=-1, keepdim=True)
    cos_parallax = torch.sum(r1 * r2w, dim=-1)
    b = t12
    r1b = torch.sum(r1 * b, dim=-1)
    r2b = torch.sum(r2w * b, dim=-1)
    cr = torch.linalg.cross(r1, r2w, dim=-1)
    den = torch.clamp(torch.sum(cr * cr, dim=-1), min=1e-12)
    s = (r1b - cos_parallax * r2b) / den
    t = (cos_parallax * r1b - r2b) / den
    p3d = 0.5 * (s[..., None] * r1 + t[..., None] * r2w + b)
    z1 = p3d[..., 2]
    R21 = R12.transpose(-1, -2)
    t21 = -torch.einsum("...ij,...j->...i", R21, t12)
    p3d_c2 = torch.einsum("...ij,...j->...i", R21, p3d) + t21
    z2 = p3d_c2[..., 2]
    return p3d, cos_parallax, z1, z2
