"""Visual-inertial per-frame optimisation and the IMU initialisation solve
(port of `orbslam3lib_tpu/tracking/inertial_opt.py`):

  * PoseInertialOptimizationLastKeyFrame / LastFrame (Optimizer.cc:4531,
    4918): the current frame's 15-dof state [pose, velocity, gyro bias,
    accel bias] against its reprojection edges, one inertial edge to the
    anchor state and the bias random-walk edges; the LastFrame form solves
    both frames (30 dof) with the previous solve's marginal information as
    a prior on the last one, and Schur-marginalises it out again;
  * InertialOptimization (Optimizer.cc:3068): gravity direction, biases and
    (monocular) scale over a keyframe window with the poses fixed.

Each solve forms one flat residual vector r(x) over a parameter vector x
and takes its Jacobian by forward-mode AD, as the reference's `jax.jacfwd`
does: every residual function takes a batch of parameter vectors (B, n),
and `jacobian_fwd` evaluates it once on n copies of x, copy k carrying the
tangent e_k (dual tensors), so all n columns come out of one pass with no
per-column overhead (`torch.func.jacfwd`'s vmap cost 0.5-0.8 s of host
time per per-frame solve on the card). The Huber weights are `.detach()`ed
inside r (the reference's stop_gradient: a detached tensor carries no
tangent), the normal equations are solved by `torch.linalg.solve_ex` (no
singularity check, which would wait for the card), and the iterations are
a Python loop. Nothing reads the card.

Numerics. The inertial edges are whitened by cholesky(inv(cov + eps I)), in
f32 as in the reference (eps 1e-8; 1e-10 in the initialisation). On phase
I's corridor (200 Hz, cfg.imu's noise; `tools/imu_conditioning.py`, both
packages on the CPU) one frame's covariance has a diagonal from 8.3e-8 to
5.2e-5 and, with the floor, a condition number of 1.85e3 (2.0e2 and 1.65e2
over the keyframe gaps of 0.25 s and 0.5 s); the f32 whitening's largest
entry is within 9.0e-7 (the port) and 4.1e-7 (the reference) of the f64
one, relative, and never NaN. So the port keeps f32, and uses `inv_ex` /
`cholesky_ex` (the checking variants wait for the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwad

from ..utils import cameras, lie
from ..utils.robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight
from . import imu as imu_mod
from .pose_opt import PoseObs


class InertialFrameState(NamedTuple):
    """One frame's inertial state: the Tcw camera pose, the body's world
    velocity and the biases. The inertial terms go through the T_bc
    extrinsic given to the solvers (ImuCamPose, G2oTypes.h:74)."""
    R: torch.Tensor    # (3, 3) world -> camera
    t: torch.Tensor    # (3,)
    v: torch.Tensor    # (3,)
    bg: torch.Tensor   # (3,)
    ba: torch.Tensor   # (3,)


def jacobian_fwd(f, x: torch.Tensor):
    """(f(x), J) for a residual function f: (B, n) -> ((B, m), aux...)
    batched over B: one forward-AD pass over n copies of x, copy k with
    tangent e_k. Returns (r (m,), J (m, n), aux primals of copy 0). Every
    batched quantity keeps its leading dimension (in torch 2.x a 0-d tensor
    with a tangent times a Python float promotes the tangent to f64)."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    with fwad.dual_level():
        out = f(fwad.make_dual(x.expand(n, n).contiguous(), eye))
        r, J = fwad.unpack_dual(out[0])
        aux = tuple(fwad.unpack_dual(a).primal[0] for a in out[1:])
    return r[0], J.T, aux


def _apply_delta(st: InertialFrameState, dx) -> InertialFrameState:
    """The state moved by deltas dx (B, 15): a left se(3) step on the pose,
    additive on the rest; every field with a leading B."""
    dR, dt = lie.se3_exp(dx[:, :6])
    R2, t2 = lie.se3_compose(dR, dt, st.R, st.t)
    return InertialFrameState(R=lie.normalize_rotation(R2), t=t2, v=st.v + dx[:, 6:9],
                              bg=st.bg + dx[:, 9:12], ba=st.ba + dx[:, 12:15])


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=like.device)


def sqrt_info(cov: torch.Tensor, eps: float) -> torch.Tensor:
    """L with L L^T = inv(cov + eps I), batched: the whitening of a residual
    r is L^T r. f32, no checks (inv_ex / cholesky_ex)."""
    n = cov.shape[-1]
    info = torch.linalg.inv_ex(cov + eps * _eye(n, cov))[0]
    return torch.linalg.cholesky_ex(info)[0]


def _mtv(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """L^T r, batched."""
    return (L.transpose(-1, -2) @ r[..., None])[..., 0]


def _bias_whitening(pre: imu_mod.Preintegrated):
    """EdgeGyroRW / EdgeAccRW information from the accumulated walk
    covariance, floored at the fixed priors 1e4 (gyro) / 1e2 (accel) so a
    preintegration without walk densities keeps a sane bias prior."""
    return sqrt_info(pre.cov_bias[..., :3, :3], 1e-4), sqrt_info(pre.cov_bias[..., 3:, 3:], 1e-2)


def _visual(st_R, st_t, obs: PoseObs, cam_params, cam_model: int, bf: float, inlier, delta):
    """Whitened, Huber-weighted reprojection residuals (B, N * 3), chi2 and
    the behind-camera mask (B, N) of poses (B, 3, 3), (B, 3). The weights
    are constants of the state (detached)."""
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
    """The reference's iteration: r and J at dx, the damped normal
    equations (H + lambda diag(H) + 1e-6 I) step = -J^T r, then the
    outliers re-classified on the updated state. Returns (dx, inlier)."""
    dx = torch.zeros(n_par, dtype=torch.float32, device=like.device)
    inlier = inlier0
    eye = _eye(n_par, like)
    for _ in range(n_iters):
        r, J, _ = jacobian_fwd(lambda d: residuals(d, inlier), dx)
        H = J.T @ J
        g = J.T @ r
        H = H + lm_lambda * torch.diag(torch.diagonal(H)) + 1e-6 * eye
        dx = dx - torch.linalg.solve_ex(H, g)[0]
        _, chi2n, behindn = residuals(dx[None], inlier)
        inlier = ((chi2n[0] <= chi2_th) & ~behindn[0]).to(torch.float32)
    return dx, inlier


def pose_inertial_optimization(cur: InertialFrameState, anchor: InertialFrameState,
                               pre: imu_mod.Preintegrated, obs: PoseObs, cam_params,
                               cam_model: int = cameras.PINHOLE, bf: float = 0.0,
                               n_iters: int = 10, lm_lambda: float = 1e-3,
                               R_bc=None, t_bc=None):
    """The current frame's 15-dof state against the fixed anchor (the last
    keyframe or frame; PoseInertialOptimizationLastKeyFrame). R_bc / t_bc:
    the IMU-from-camera extrinsic (identity when None).

    Returns (state, inlier_mask, n_inliers (0-d int32), H_marg): H_marg is
    the 15x15 Gauss-Newton Hessian at the solution, the prior of the next
    frame's `pose_inertial_optimization_last_frame`."""
    R_bc = _eye(3, cur.R) if R_bc is None else R_bc
    t_bc = torch.zeros(3, device=cur.R.device) if t_bc is None else t_bc
    L9 = sqrt_info(pre.cov, 1e-8)
    Lbg, Lba = _bias_whitening(pre)
    chi2_th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO)
    R1, p1 = imu_mod.body_from_cam(anchor.R, anchor.t, R_bc, t_bc)

    def residuals(dx, inlier):
        st = _apply_delta(cur, dx)
        r_vis, chi2, behind = _visual(st.R, st.t, obs, cam_params, cam_model, bf, inlier, delta)
        R2, p2 = imu_mod.body_from_cam(st.R, st.t, R_bc, t_bc)
        r_imu = _mtv(L9, imu_mod.inertial_residual(R1, anchor.v, p1, R2, st.v, p2,
                                                   st.bg, st.ba, pre))
        r_bg = _mtv(Lbg, st.bg - anchor.bg)
        r_ba = _mtv(Lba, st.ba - anchor.ba)
        return torch.cat([r_vis, r_imu, r_bg, r_ba], dim=-1), chi2, behind

    inl0 = torch.ones(obs.valid.shape, dtype=torch.float32, device=cur.R.device)
    dx, inlier = _gauss_newton(residuals, 15, n_iters, lm_lambda, inl0, chi2_th, cur.R)
    st = _first(_apply_delta(cur, dx[None]))
    inlier_mask = (inlier > 0) & obs.valid
    _, J, _ = jacobian_fwd(lambda d: residuals(d, inlier), dx)
    return st, inlier_mask, torch.sum(inlier_mask.to(torch.int32)), J.T @ J


def pose_inertial_optimization_last_frame(
        cur: InertialFrameState, last: InertialFrameState, prior_H,
        pre: imu_mod.Preintegrated, obs: PoseObs, cam_params,
        cam_model: int = cameras.PINHOLE, bf: float = 0.0, n_iters: int = 10,
        lm_lambda: float = 1e-3, R_bc=None, t_bc=None):
    """PoseInertialOptimizationLastFrame (Optimizer.cc:4918): both frames'
    states (30 dof). The last frame is held by the ConstraintPoseImu prior
    (EdgePriorPoseImu, G2oTypes.h:706: its own mean `last`, information
    `prior_H`); the current frame carries the visual edges; an inertial
    edge and the bias random-walk edges join the two. The last frame's
    block is then Schur-marginalised out of the Hessian: H_marg is the next
    frame's prior. Returns (cur_state, inlier_mask, n_inliers, H_marg)."""
    R_bc = _eye(3, cur.R) if R_bc is None else R_bc
    t_bc = torch.zeros(3, device=cur.R.device) if t_bc is None else t_bc
    L9 = sqrt_info(pre.cov, 1e-8)
    Lbg, Lba = _bias_whitening(pre)
    chi2_th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO)
    Hp = 0.5 * (prior_H + prior_H.T)
    L_prior = torch.linalg.cholesky_ex(Hp + 1e-4 * _eye(15, Hp))[0]

    def residuals(dx, inlier):
        st_l = _apply_delta(last, dx[:, :15])
        st_c = _apply_delta(cur, dx[:, 15:])
        r_vis, chi2, behind = _visual(st_c.R, st_c.t, obs, cam_params, cam_model, bf,
                                      inlier, delta)
        R1, p1 = imu_mod.body_from_cam(st_l.R, st_l.t, R_bc, t_bc)
        R2, p2 = imu_mod.body_from_cam(st_c.R, st_c.t, R_bc, t_bc)
        r_imu = _mtv(L9, imu_mod.inertial_residual(R1, st_l.v, p1, R2, st_c.v, p2,
                                                   st_l.bg, st_l.ba, pre))
        r_bg = _mtv(Lbg, st_c.bg - st_l.bg)
        r_ba = _mtv(Lba, st_c.ba - st_l.ba)
        # the prior on the last frame: its mean is the chart origin, so the
        # residual is the whitened delta itself
        r_prior = _mtv(L_prior, dx[:, :15])
        return torch.cat([r_vis, r_imu, r_bg, r_ba, r_prior], dim=-1), chi2, behind

    inl0 = torch.ones(obs.valid.shape, dtype=torch.float32, device=cur.R.device)
    dx, inlier = _gauss_newton(residuals, 30, n_iters, lm_lambda, inl0, chi2_th, cur.R)
    st_c = _first(_apply_delta(cur, dx[None, 15:]))
    inlier_mask = (inlier > 0) & obs.valid
    _, J, _ = jacobian_fwd(lambda d: residuals(d, inlier), dx)
    H = J.T @ J
    Hll = H[:15, :15] + 1e-6 * _eye(15, H)
    Hcl = H[15:, :15]
    H_marg = H[15:, 15:] - Hcl @ torch.linalg.solve_ex(Hll, Hcl.T)[0]
    return st_c, inlier_mask, torch.sum(inlier_mask.to(torch.int32)), H_marg


def _first(st: InertialFrameState) -> InertialFrameState:
    return InertialFrameState(*(x[0] for x in st))


def closed_form_velocities(Rwb, p, pres: imu_mod.Preintegrated, bg, ba, g_w):
    """Each gap's start velocity from p2 = p1 + v1 dt + 0.5 g dt^2 + R1 dP,
    and the last keyframe's from the last gap's dV: (..., K, 3) for the K
    body rotations Rwb (K, 3, 3), positions p (..., K, 3), the K - 1
    stacked gaps and biases and gravity (..., 3)."""
    dR, dV, dP = imu_mod.corrected_deltas(pres, bg[..., None, :], ba[..., None, :])
    dt = torch.clamp(pres.dt, min=1e-4)[:, None]
    v1 = (p[..., 1:, :] - p[..., :-1, :] - 0.5 * g_w[..., None, :] * (dt ** 2)
          - lie._matvec(Rwb[:-1], dP)) / dt
    v_last = v1[..., -1, :] + g_w * dt[-1] + lie._matvec(Rwb[-2], dV[..., -1, :])
    return torch.cat([v1, v_last[..., None, :]], dim=-2)


def inertial_init_optimization(kf_R, kf_t, kf_valid, pres: imu_mod.Preintegrated, pre_valid,
                               n_iters: int = 60, opt_scale: bool = False,
                               prior_g: float = 1e2, prior_a: float = 1e6,
                               R_bc=None, t_bc=None):
    """Gravity direction, biases and (monocular) scale over a keyframe window
    with the poses fixed (InertialOptimization, Optimizer.cc:3068, as
    LocalMapping::InitializeIMU uses it). kf_R / kf_t (K, 3, 3) / (K, 3):
    Tcw poses; pres: the K - 1 gaps stacked; pre_valid (K - 1,). The
    velocities follow in closed form from the positions at every iteration;
    x = [the gravity rotation about x and z (2), bg (3), ba (3), log s (1,
    with opt_scale)].

    Returns (R_wg, bg, ba, s (0-d), velocities (K, 3))."""
    dev = kf_R.device
    g_ref = imu_mod.gravity_w(kf_R)
    R_bc = _eye(3, kf_R) if R_bc is None else R_bc
    t_bc = torch.zeros(3, device=dev) if t_bc is None else t_bc
    Rwc = kf_R.transpose(-1, -2)
    c_w = -lie._matvec(Rwc, kf_t)                         # camera centres
    Rwb = Rwc @ R_bc.T
    lever = -lie._matvec(Rwb, t_bc)                       # metric, not scaled
    # each gap whitened by its preintegration's information (EdgeInertialGS);
    # without it the bias priors dominate the small residuals
    L9 = sqrt_info(pres.cov, 1e-10)                       # (K-1, 9, 9)
    pv = pre_valid.to(torch.float32)[:, None]
    n_par = 9 if opt_scale else 8

    def unpack(x):
        """x (B, n_par) -> R_wg (B, 3, 3), bg, ba (B, 3), s (B, 1)."""
        z = torch.zeros_like(x[:, :1])
        R_wg = lie.so3_exp(torch.cat([x[:, 0:1], z, x[:, 1:2]], dim=-1))
        s = torch.exp(x[:, 8:9]) if opt_scale else torch.ones_like(z)
        return R_wg, x[:, 2:5], x[:, 5:8], s

    def positions(s):
        return s[:, None] * c_w + lever                   # (B, K, 3)

    def residual(x):
        R_wg, bg, ba, s = unpack(x)
        g_w = lie._matvec(R_wg, g_ref)
        p = positions(s)
        v = closed_form_velocities(Rwb, p, pres, bg, ba, g_w)
        r = imu_mod.inertial_residual(Rwb[:-1], v[:, :-1], p[:, :-1], Rwb[1:], v[:, 1:],
                                      p[:, 1:], bg[:, None], ba[:, None], pres,
                                      g_w=g_w[:, None])
        r_gaps = (_mtv(L9, r) * pv).reshape(x.shape[0], -1)
        r_prior = torch.cat([bg * prior_g ** 0.5, ba * prior_a ** 0.5], dim=-1)
        return (torch.cat([r_gaps, r_prior], dim=-1),)

    x = torch.zeros(n_par, dtype=torch.float32, device=dev)
    eye = _eye(n_par, x)
    for _ in range(n_iters):
        r, J, _ = jacobian_fwd(residual, x)
        H = J.T @ J + 1e-6 * eye
        x = x - torch.linalg.solve_ex(H, J.T @ r)[0]
    R_wg, bg, ba, s = unpack(x[None])
    v = closed_form_velocities(Rwb, positions(s), pres, bg, ba, lie._matvec(R_wg, g_ref))
    return R_wg[0], bg[0], ba[0], s[0, 0], v[0]
