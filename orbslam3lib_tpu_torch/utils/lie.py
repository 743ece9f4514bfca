"""SO(3), SE(3) and Sim(3) (port of `orbslam3lib_tpu/utils/lie.py`).

Conventions as in the reference: rotations are (..., 3, 3) matrices, SE(3)
is a pair (R, t), Sim(3) a triple (R, t, s), se(3) tangents are [rho, phi]
(translation first) and sim(3) tangents [rho, phi, sigma]. Every function is
batched over leading dimensions and pure: no in-place writes and no Python
branch on a tensor's value (small-angle cases go through `torch.where`), so
`torch.func.vmap` / `jacfwd` trace them, and nothing waits for the card.
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwad

from .smallmat import inv3

_EPS = 1e-8
# below this theta^2 the coefficients of the exp maps and Jacobians take
# their series (the reference takes them only below _EPS: its f32
# derivatives are noise for theta in ~[1e-4, 1e-1], ROADMAP queue 3)
_SERIES_THETA2 = 0.09
# the dtype of `_sim3_W`'s coefficients (None: the input's, the reference's)
_SIM3_W_DTYPE = torch.float64


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


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


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3), Jr(w) = Jl(-w) (ImuTypes.h:193-199)."""
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3), with its small-angle series."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    small = theta2 < _SERIES_THETA2
    coef = torch.where(small, 1.0 / 12.0 + theta2 * (1.0 / 720.0 + theta2 * (
        1.0 / 30240.0 + theta2 / 1209600.0)),
                       1.0 / theta2 - (1.0 + torch.cos(theta))
                       / (2.0 * theta * torch.sin(theta) + _EPS))
    return _eye_like(W) + 0.5 * W + coef[..., None, None] * (W @ W)


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


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) log -> (..., 6) [rho, phi]."""
    phi = so3_log(R)
    rho = _matvec(so3_right_jacobian_inv(-phi), t)
    return torch.cat([rho, phi], dim=-1)


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


def se3_matrix(R, t):
    """(R, t) as a (..., 4, 4) homogeneous matrix."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


# -- Sim(3): loop closing (Sim3Solver, OptimizeSim3, the essential graph) --

def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) W matrix of sim3_exp (t = W rho): (..., 3) x (...,) ->
    (..., 3, 3), closed forms per small-angle / small-scale regime. Their
    cancellations leave f32 derivatives of rounding noise for theta or sigma
    in ~[1e-4, 1e-1] (the reference's fault, as in `_sin_cos_coeffs`; two
    variables have no short series), so the coefficients are computed in
    `_SIM3_W_DTYPE` (f64) and rounded once."""
    dtype = phi.dtype
    W = hat(phi)
    if _SIM3_W_DTYPE is not None:
        phi, sigma = phi.to(_SIM3_W_DTYPE), sigma.to(_SIM3_W_DTYPE)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    s = torch.exp(sigma)
    small_s = torch.abs(sigma) < 1e-4
    small_t = theta < 1e-4
    sig = torch.where(small_s, torch.ones_like(sigma), sigma)  # safe denominators
    th = torch.where(small_t, torch.ones_like(theta), theta)
    cI = torch.where(small_s, torch.ones_like(s), (s - 1.0) / sig)

    sin_t, cos_t = torch.sin(th), torch.cos(th)
    c = th * th + sig * sig
    a_g = s * sin_t
    b_g = s * cos_t
    cW_gen = (a_g * sig + (1.0 - b_g) * th) / (th * c)
    cW2_gen = (cI - ((b_g - 1.0) * sig + a_g * th) / c) / (th * th)
    cW_st = ((sig - 1.0) * s + 1.0) / (sig * sig)             # theta -> 0
    cW2_st = (s * (0.5 * sig * sig - sig + 1.0) - 1.0) / (sig ** 3)
    cW_ss = (1.0 - cos_t) / (th * th)                         # sigma -> 0
    cW2_ss = (th - sin_t) / (th ** 3)
    half = torch.full_like(sigma, 0.5)
    sixth = torch.full_like(sigma, 1.0 / 6.0)
    cW = torch.where(small_s, torch.where(small_t, half, cW_ss),
                     torch.where(small_t, cW_st, cW_gen))
    cW2 = torch.where(small_s, torch.where(small_t, sixth, cW2_ss),
                      torch.where(small_t, cW2_st, cW2_gen))
    cI, cW, cW2 = cI.to(dtype), cW.to(dtype), cW2.to(dtype)
    return (cI[..., None, None] * _eye_like(W) + cW[..., None, None] * W
            + cW2[..., None, None] * (W @ W))


def sim3_exp(xi: torch.Tensor):
    """sim(3) exp: [rho, phi, sigma] (..., 7) -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return so3_exp(phi), _matvec(_sim3_W(phi, sigma), rho), torch.exp(sigma)


def sim3_log(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Sim(3) log -> (..., 7) [rho, phi, sigma], the inverse of sim3_exp. W
    is inverted in closed form (the reference solves by LU): no pivoting is
    needed for W, whose spectrum stays near (s - 1) / sigma."""
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = _matvec(inv3(_sim3_W(phi, sigma)), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_apply(R, t, s, p):
    return s[..., None] * _matvec(R, p) + t


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * _matvec(Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    return Ra @ Rb, sa[..., None] * _matvec(Ra, tb) + ta, sa * sb


def value_and_rowwise_jacobian(f, x: torch.Tensor, *row_args):
    """y = f(x, *row_args) and its forward-mode Jacobian (E, ..., n), for an
    f whose row e of y (E, ...) depends only on row e of x (E, n) and of each
    row_arg. The reference vmaps `jax.jacfwd` over the rows; here one
    forward-mode product covers all n columns at once: the rows are
    repeated n times, copy k carrying the tangent e_k, and y is copy 0's
    primal. Keep every row at least 1-d: in torch 2.x forward mode through
    a 0-d tensor times a Python float promotes the tangent to f64."""
    n, E = x.shape[-1], x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    tangent = eye.repeat_interleave(E, dim=0)                 # copy k: e_k
    reps = [a.repeat((n,) + (1,) * (a.dim() - 1)) for a in row_args]
    with fwad.dual_level():
        y, dy = fwad.unpack_dual(f(fwad.make_dual(x.repeat(n, 1), tangent), *reps))
    dy = dy.reshape((n, E) + dy.shape[1:])
    return y[:E], dy.permute(tuple(range(1, dy.dim())) + (0,))
