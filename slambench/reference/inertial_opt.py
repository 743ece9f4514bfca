"""The per-frame visual-inertial solve (port of the port's
`tracking/inertial_opt.py`: PoseInertialOptimizationLastKeyFrame and
LastFrame, Optimizer.cc:4531 and 4918), in the dtype of its inputs.

One flat residual vector r(x) (Huber-weighted reprojection with detached
weights, the whitened inertial edge, the bias random-walk edges and, in the
LastFrame form, the previous solve's marginal prior), its Jacobian by
forward-mode AD over a batch of copies of x, and damped Gauss-Newton steps
with the outliers re-classified after each.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwad

from . import cameras, lie
from .imu import Pre, body_from_cam, corrected_deltas, inertial_residual
from .pose_opt import PoseObs
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class State(NamedTuple):
    """One frame's inertial state: the Tcw pose, the body's world velocity
    and the biases."""
    R: torch.Tensor
    t: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor


def jacobian_fwd(f, x: torch.Tensor):
    """(f(x), J): one forward-AD pass over n copies of x, copy k with
    tangent e_k. f maps (B, n) to ((B, m), aux...)."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    with fwad.dual_level():
        out = f(fwad.make_dual(x.expand(n, n).contiguous(), eye))
        r, J = fwad.unpack_dual(out[0])
        aux = tuple(fwad.unpack_dual(a).primal[0] for a in out[1:])
    return r[0], J.T, aux


def _apply_delta(st: State, dx) -> State:
    """A left se(3) step on the pose, additive on the rest (dx (B, 15))."""
    dR, dt = lie.se3_exp(dx[:, :6])
    R2, t2 = lie.se3_compose(dR, dt, st.R, st.t)
    return State(R=lie.normalize_rotation(R2), t=t2, v=st.v + dx[:, 6:9],
                 bg=st.bg + dx[:, 9:12], ba=st.ba + dx[:, 12:15])


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def sqrt_info(cov: torch.Tensor, eps: float) -> torch.Tensor:
    """L with L L^T = inv(cov + eps I), batched."""
    n = cov.shape[-1]
    info = torch.linalg.inv_ex(cov + eps * _eye(n, cov))[0]
    return torch.linalg.cholesky_ex(info)[0]


def _mtv(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return (L.transpose(-1, -2) @ r[..., None])[..., 0]


def _bias_whitening(pre: Pre):
    return sqrt_info(pre.cov_bias[..., :3, :3], 1e-4), sqrt_info(pre.cov_bias[..., 3:, 3:], 1e-2)


def _visual(st_R, st_t, obs: PoseObs, cam_params, cam_model: int, bf: float, inlier, delta):
    p_c = lie.se3_apply(st_R[:, None], st_t[:, None], obs.p_world)
    uv_hat = cameras.project(cam_model, cam_params, p_c)
    z = p_c[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    r2 = uv_hat - obs.uv
    r3 = torch.where(obs.is_stereo, uv_hat[..., 0] - torch.full_like(z, bf) / z_safe - obs.u_right,
                     torch.zeros_like(z))
    r_vis = torch.cat([r2, r3[..., None]], dim=-1)
    chi2 = torch.sum(r_vis * r_vis, dim=-1) * obs.inv_sigma2
    behind = z <= 0.05
    w = (obs.inv_sigma2 * huber_weight(chi2, delta) * inlier * obs.valid.to(z.dtype)
         * (~behind).to(z.dtype)).detach()
    return (r_vis * torch.sqrt(w)[..., None]).reshape(r_vis.shape[0], -1), chi2, behind


def _gauss_newton(residuals, n_par: int, n_iters: int, lm_lambda: float, inlier0, chi2_th,
                  like: torch.Tensor):
    dx = torch.zeros(n_par, dtype=like.dtype, device=like.device)
    inlier = inlier0
    eye = _eye(n_par, like)
    for _ in range(n_iters):
        r, J, _ = jacobian_fwd(lambda d: residuals(d, inlier), dx)
        H = J.T @ J
        g = J.T @ r
        H = H + lm_lambda * torch.diag(torch.diagonal(H)) + 1e-6 * eye
        dx = dx - torch.linalg.solve_ex(H, g)[0]
        _, chi2n, behindn = residuals(dx[None], inlier)
        inlier = ((chi2n[0] <= chi2_th) & ~behindn[0]).to(like.dtype)
    return dx, inlier


def _first(st: State) -> State:
    return State(*(x[0] for x in st))


def pose_inertial_optimization(cur: State, anchor: State, pre: Pre, obs: PoseObs, cam_params,
                               cam_model: int, bf: float, R_bc, t_bc, n_iters: int = 10,
                               lm_lambda: float = 1e-3) -> State:
    """The current frame's 15-dof state against the fixed anchor."""
    L9 = sqrt_info(pre.cov, 1e-8)
    Lbg, Lba = _bias_whitening(pre)
    chi2_th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(cur.R.dtype)
    delta = torch.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO).to(cur.R.dtype)
    R1, p1 = body_from_cam(anchor.R, anchor.t, R_bc, t_bc)

    def residuals(dx, inlier):
        st = _apply_delta(cur, dx)
        r_vis, chi2, behind = _visual(st.R, st.t, obs, cam_params, cam_model, bf, inlier, delta)
        R2, p2 = body_from_cam(st.R, st.t, R_bc, t_bc)
        r_imu = _mtv(L9, inertial_residual(R1, anchor.v, p1, R2, st.v, p2, st.bg, st.ba, pre))
        r_bg = _mtv(Lbg, st.bg - anchor.bg)
        r_ba = _mtv(Lba, st.ba - anchor.ba)
        return torch.cat([r_vis, r_imu, r_bg, r_ba], dim=-1), chi2, behind

    inl0 = torch.ones(obs.valid.shape, dtype=cur.R.dtype, device=cur.R.device)
    dx, _ = _gauss_newton(residuals, 15, n_iters, lm_lambda, inl0, chi2_th, cur.R)
    return _first(_apply_delta(cur, dx[None]))


def pose_inertial_optimization_last_frame(cur: State, last: State, prior_H, pre: Pre,
                                          obs: PoseObs, cam_params, cam_model: int, bf: float,
                                          R_bc, t_bc, n_iters: int = 10,
                                          lm_lambda: float = 1e-3) -> State:
    """Both frames' states (30 dof), the last one held by the previous
    solve's marginal information `prior_H` about its own mean."""
    L9 = sqrt_info(pre.cov, 1e-8)
    Lbg, Lba = _bias_whitening(pre)
    chi2_th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(cur.R.dtype)
    delta = torch.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO).to(cur.R.dtype)
    Hp = 0.5 * (prior_H + prior_H.T)
    L_prior = torch.linalg.cholesky_ex(Hp + 1e-4 * _eye(15, Hp))[0]

    def residuals(dx, inlier):
        st_l = _apply_delta(last, dx[:, :15])
        st_c = _apply_delta(cur, dx[:, 15:])
        r_vis, chi2, behind = _visual(st_c.R, st_c.t, obs, cam_params, cam_model, bf,
                                      inlier, delta)
        R1, p1 = body_from_cam(st_l.R, st_l.t, R_bc, t_bc)
        R2, p2 = body_from_cam(st_c.R, st_c.t, R_bc, t_bc)
        r_imu = _mtv(L9, inertial_residual(R1, st_l.v, p1, R2, st_c.v, p2,
                                           st_l.bg, st_l.ba, pre))
        r_bg = _mtv(Lbg, st_c.bg - st_l.bg)
        r_ba = _mtv(Lba, st_c.ba - st_l.ba)
        r_prior = _mtv(L_prior, dx[:, :15])
        return torch.cat([r_vis, r_imu, r_bg, r_ba, r_prior], dim=-1), chi2, behind

    inl0 = torch.ones(obs.valid.shape, dtype=cur.R.dtype, device=cur.R.device)
    dx, _ = _gauss_newton(residuals, 30, n_iters, lm_lambda, inl0, chi2_th, cur.R)
    return _first(_apply_delta(cur, dx[None, 15:]))


def closed_form_velocities(Rwb, p, pres: Pre, bg, ba, g_w):
    """Each gap's start velocity from p2 = p1 + v1 dt + 0.5 g dt^2 + R1 dP,
    and the last keyframe's from the last gap's dV."""
    dR, dV, dP = corrected_deltas(pres, bg[..., None, :], ba[..., None, :])
    dt = torch.clamp(pres.dt, min=1e-4)[:, None]
    v1 = (p[..., 1:, :] - p[..., :-1, :] - 0.5 * g_w[..., None, :] * (dt ** 2)
          - lie._matvec(Rwb[:-1], dP)) / dt
    v_last = v1[..., -1, :] + g_w * dt[-1] + lie._matvec(Rwb[-2], dV[..., -1, :])
    return torch.cat([v1, v_last[..., None, :]], dim=-2)
