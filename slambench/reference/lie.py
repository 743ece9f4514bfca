"""SO(3) and SE(3) (port of `orbslam3lib_tpu/utils/lie.py`).

Conventions as in the reference: rotations are (..., 3, 3) matrices, SE(3)
is a pair (R, t) and se(3) tangents are [rho, phi] (translation
first). Every function is
batched over leading dimensions and pure: no in-place writes and no Python
branch on a tensor's value (small-angle cases go through `torch.where`), so
`torch.func.vmap` / `jacfwd` trace them, and nothing waits for the card.
"""
from __future__ import annotations

import torch

_EPS = 1e-8
# below this theta^2 the coefficients of the exp maps and Jacobians take
# their series (the reference takes them only below _EPS: its f32
# derivatives are noise for theta in ~[1e-4, 1e-1], ROADMAP queue 3)
_SERIES_THETA2 = 0.09


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _sin_cos_coeffs(theta2: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), by their Taylor series in
    theta^2 below `_SERIES_THETA2`: there the f32 closed forms cancel, and
    their forward-mode derivatives are rounding noise (the series are exact
    to f32 over that range; `tools/lie_small_angle.py` measures both)."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _SERIES_THETA2
    A = torch.where(small, 1.0 + theta2 * (-1.0 / 6.0 + theta2 * (
        1.0 / 120.0 - theta2 / 5040.0)), torch.sin(theta) / theta)
    B = torch.where(small, 0.5 + theta2 * (-1.0 / 24.0 + theta2 * (
        1.0 / 720.0 - theta2 / 40320.0)), (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 + theta2 * (-1.0 / 120.0 + theta2 * (
        1.0 / 5040.0 - theta2 / 362880.0)), (theta - torch.sin(theta)) / (theta2 * theta))
    return A, B, C


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sin_cos_coeffs(theta2)
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sin_cos_coeffs(theta2)
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z) with w >= 0
    (branch-free Shepperd selection, as in the reference)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                         1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    k = torch.argmax(cands, dim=-1)
    sq = torch.sqrt(torch.clamp(torch.amax(cands, dim=-1), min=_EPS)) * 2.0
    q_w = torch.stack([0.25 * sq, (m21 - m12) / sq, (m02 - m20) / sq, (m10 - m01) / sq], dim=-1)
    q_x = torch.stack([(m21 - m12) / sq, 0.25 * sq, (m01 + m10) / sq, (m02 + m20) / sq], dim=-1)
    q_y = torch.stack([(m02 - m20) / sq, (m01 + m10) / sq, 0.25 * sq, (m12 + m21) / sq], dim=-1)
    q_z = torch.stack([(m10 - m01) / sq, (m02 + m20) / sq, (m12 + m21) / sq, 0.25 * sq], dim=-1)
    k = k[..., None]
    q = torch.where(k == 0, q_w, torch.where(k == 1, q_x, torch.where(k == 2, q_y, q_z)))
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) (via the quaternion)."""
    return quat_to_rotmat(rotmat_to_quat(R))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log of a rotation: (..., 3, 3) -> (..., 3) (quaternion route)."""
    q = rotmat_to_quat(R)
    qw, qv = q[..., 0], q[..., 1:]
    nv2 = torch.sum(qv * qv, dim=-1)
    small = nv2 < 1e-12
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    qw_safe = torch.clamp(qw, min=_EPS)
    scale_big = 2.0 * torch.atan2(nv, qw) / nv
    scale_small = 2.0 / qw_safe - 2.0 * nv2 / (3.0 * qw_safe ** 3)
    return torch.where(small, scale_small, scale_big)[..., None] * qv


def se3_exp(xi: torch.Tensor):
    """se(3) exp: [rho, phi] (..., 6) -> (R (..., 3, 3), t (..., 3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def _matvec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) applied to v (..., 3), broadcasting like the reference's
    einsum('...ij,...j->...i')."""
    return torch.sum(R * v[..., None, :], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, _matvec(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se3_apply(R, t, p):
    """Apply the transform to points p (..., 3)."""
    return _matvec(R, p) + t
