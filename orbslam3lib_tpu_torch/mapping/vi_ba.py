"""Sliding-window visual-inertial BA (port of `orbslam3lib_tpu/mapping/
vi_ba.py`, the reference's LocalInertialBA, Optimizer.cc:2405).

The pass alternates with the visual Schur BA (mapping/map_ba.py): the
visual pass refines poses and landmarks, this one the window keyframes'
poses, velocities and biases against the preintegration chain with the
landmarks held fixed. With `per_kf_bias` (the configuration's default) each
keyframe has its own gyro and accel bias, tied to its neighbour's by the
gap's random-walk information (15 C parameters, the reference's vertex
layout); otherwise the window shares one bias (9 C + 6). The velocities
start from each keyframe's stored one where it has one, else in closed form
from consecutive positions (`inertial_opt.closed_form_velocities`).

The solve is the reference's: one flat residual vector (Huber-weighted
reprojection with detached weights, whitened inertial edges, bias terms),
`n_iters` Gauss-Newton steps (J^T J + 1e-5 I) from x = 0, x measured from
the window's start state. Nothing reads the card. Two paths:

- On CUDA tensors with the pinhole camera and per-keyframe biases (EuRoC's
  setup and the configuration's default) each iteration is one `vi_eval`
  and one `vi_step` launch (`ops/cuda_vi.py`, `csrc/vi_opt.cu`): each edge's
  Jacobian in closed form, reduced per keyframe chunk and per gap, summed
  into the block-tridiagonal H and solved on the card.
  `_normal_equations_torch` is their plain version (H and g from the same
  analytic Jacobians); `cuda_vi.eval_launches` counts their evaluations.
- Elsewhere (the CPU, the other camera models, the shared bias) the dense
  Jacobian by forward-mode AD over all parameters in one pass
  (`inertial_opt.jacobian_fwd`), J^T J + 1e-5 I solved by `solve_ex`, in a
  Python loop; `evals_torch` counts its evaluations.

The analytic Jacobians: each edge's with respect to a left se(3)
perturbation of the current Tcw (d p_c = [I | -hat(p_c)] xi for a visual
row; the inertial edge's through T_bc, after ORB-SLAM3's
`EdgeInertial::linearizeOplus`, G2oTypes.cc) and additive ones of v, bg and
ba, times each free keyframe's SE(3) left Jacobian at its x[:6]
(`_se3_left_jacobian`): x is absolute, so the chart is
exp(x) T0 and not the identity.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models import map_state as ms
from ..ops import cuda_vi
from ..tracking import imu as imu_mod
from ..tracking.inertial_opt import closed_form_velocities, jacobian_fwd, sqrt_info
from ..utils import cameras, lie
from ..utils.robust import DELTA_MONO, DELTA_STEREO, huber_weight
from .map_ba import inv_sigma2

evals_torch = 0   # window evaluations by the torch path (a host count)


class VIWindowResult(NamedTuple):
    kf_R: torch.Tensor   # (C, 3, 3) window poses
    kf_t: torch.Tensor   # (C, 3)
    v: torch.Tensor      # (C, 3) world velocities
    bg: torch.Tensor     # (3,) the window's gyro bias, or (C, 3) per keyframe
    ba: torch.Tensor     # (3,) or (C, 3)

    @property
    def last_bias(self):
        """(bg, ba) of the newest keyframe, in either bias mode."""
        if self.bg.ndim == 1:
            return self.bg, self.ba
        return self.bg[-1], self.ba[-1]


def _fused(device: torch.device, cam_model: int, per_kf_bias: bool) -> bool:
    """Whether the window runs its kernels: CUDA tensors, pinhole, a bias
    per keyframe."""
    return device.type == "cuda" and cam_model == cameras.PINHOLE and per_kf_bias


class Window(NamedTuple):
    """One window's problem, set up once for every iteration: the start
    state, which parameters are free, the visual rows (C, F) and the gaps'
    inertial terms (C - 1)."""
    C: int
    per_kf_bias: bool
    R0: torch.Tensor          # (C, 3, 3) Tcw at x = 0
    t0: torch.Tensor          # (C, 3)
    v0: torch.Tensor          # (C, 3)
    bg0: torch.Tensor         # (3,) the incoming biases
    ba0: torch.Tensor
    free_pose: torch.Tensor   # (C, 1) 0/1
    free_vel: torch.Tensor    # (C, 1) 0/1: velocity and biases
    p_w: torch.Tensor         # (C, F, 3) landmarks
    uv: torch.Tensor          # (C, F, 2) measured left pixels
    w_sig: torch.Tensor       # (C, F) inv_sigma2
    is_stereo: torch.Tensor   # (C, F) bool
    u_right: torch.Tensor     # (C, F)
    delta: torch.Tensor       # (C, F) Huber thresholds
    obs_f: torch.Tensor       # (C, F) 0/1
    pres: imu_mod.Preintegrated   # (C - 1) stacked gaps
    L9: torch.Tensor          # (C - 1, 9, 9) whitening of the inertial edges
    gap_ok: torch.Tensor      # (C - 1,) 0/1
    Lbg_rw: Optional[torch.Tensor]   # (C - 1, 3, 3) random walks (per_kf_bias)
    Lba_rw: Optional[torch.Tensor]
    R_bc: torch.Tensor
    t_bc: torch.Tensor
    cam_params: torch.Tensor
    cam_model: int
    bf: float

    @property
    def n_par(self) -> int:
        return 15 * self.C if self.per_kf_bias else 9 * self.C + 6


def window_problem(m: ms.MapState, window_ids, fixed_mask, pres: imu_mod.Preintegrated,
                   pre_valid, bg0, ba0, cam_params, bf: float,
                   cam_model: int = cameras.PINHOLE, n_levels: int = 8, R_bc=None,
                   t_bc=None, v_init=None, v_init_valid=None,
                   per_kf_bias: bool = False) -> Window:
    """The `Window` of `local_inertial_ba`'s arguments (see there), in the
    map's dtype."""
    dev = m.kf_R.device
    fdt = m.kf_R.dtype
    R_bc = torch.eye(3, dtype=fdt, device=dev) if R_bc is None else R_bc
    t_bc = torch.zeros(3, dtype=fdt, device=dev) if t_bc is None else t_bc
    C = window_ids.shape[0]
    ids = torch.clamp(window_ids, 0, m.max_kf - 1).long()
    cam_ok = (window_ids >= 0) & m.kf_valid[ids]

    # visual observations: each window keyframe against its own landmarks
    kf_mp_raw = m.kf_mp[ids]                                        # (C, F)
    kf_mp = torch.clamp(kf_mp_raw, 0, m.max_mp - 1).long()
    obs_ok = cam_ok[:, None] & m.kf_feat_valid[ids] & (kf_mp_raw >= 0) & m.mp_valid[kf_mp]
    p_w = m.mp_pos[kf_mp]                                           # (C, F, 3)
    uv = m.kf_xy[ids]
    w_sig = inv_sigma2(m.kf_level[ids], n_levels)
    depth = m.kf_depth[ids]
    is_stereo = obs_ok & (depth > 0.05)
    z_safe = torch.clamp(depth, min=0.05)
    u_right = torch.where(is_stereo, uv[..., 0] - torch.full_like(z_safe, bf) / z_safe,
                          torch.zeros_like(z_safe))
    delta = torch.where(is_stereo, DELTA_STEREO, DELTA_MONO)
    obs_f = obs_ok.to(fdt)

    R0, t0 = m.kf_R[ids], m.kf_t[ids]
    Rwb0, p0 = imu_mod.body_from_cam(R0, t0, R_bc, t_bc)
    g_w = imu_mod.gravity_w(R0)
    v_cf = closed_form_velocities(Rwb0, p0, pres, bg0, ba0, g_w)
    if v_init is None:
        v0 = v_cf
    else:
        v0 = torch.where((v_init_valid & cam_ok)[:, None], v_init, v_cf)

    L9 = sqrt_info(pres.cov, 1e-8)                                 # (C-1, 9, 9)
    gap_ok = (pre_valid & cam_ok[:-1] & cam_ok[1:]).to(fdt)
    # anchors hold their pose; every valid keyframe's velocity stays free
    free_pose = (cam_ok & ~fixed_mask).to(fdt)[:, None]
    free_vel = cam_ok.to(fdt)[:, None]
    Lbg_rw = Lba_rw = None
    if per_kf_bias:
        # EdgeGyroRW / EdgeAccRW: each gap's inverse accumulated walk
        # covariance
        Lbg_rw = sqrt_info(pres.cov_bias[:, :3, :3], 1e-4)         # (C-1, 3, 3)
        Lba_rw = sqrt_info(pres.cov_bias[:, 3:, 3:], 1e-2)
    return Window(C=C, per_kf_bias=per_kf_bias, R0=R0, t0=t0, v0=v0, bg0=bg0, ba0=ba0,
                  free_pose=free_pose, free_vel=free_vel, p_w=p_w, uv=uv, w_sig=w_sig,
                  is_stereo=is_stereo, u_right=u_right, delta=delta, obs_f=obs_f, pres=pres,
                  L9=L9, gap_ok=gap_ok, Lbg_rw=Lbg_rw, Lba_rw=Lba_rw, R_bc=R_bc, t_bc=t_bc,
                  cam_params=cam_params, cam_model=cam_model, bf=bf)


def _unpack(w: Window, x):
    """x (B, n_par) -> poses (B, C, 3, 3), (B, C, 3), velocities (B, C, 3)
    and biases (B, C, 3) per keyframe or (B, 3) shared."""
    B, C = x.shape[0], w.C
    if w.per_kf_bias:
        dkf = x.reshape(B, C, 15)
        bg = w.bg0 + dkf[..., 9:12] * w.free_vel
        ba = w.ba0 + dkf[..., 12:15] * w.free_vel
    else:
        dkf = x[:, :9 * C].reshape(B, C, 9)
        bg = w.bg0 + x[:, 9 * C:9 * C + 3]
        ba = w.ba0 + x[:, 9 * C + 3:]
    dR, dt = lie.se3_exp(dkf[..., :6] * w.free_pose)
    R, t = lie.se3_compose(dR, dt, w.R0, w.t0)
    return lie.normalize_rotation(R), t, w.v0 + dkf[..., 6:9] * w.free_vel, bg, ba


def _visual(w: Window, R, t):
    """The visual rows at poses (B, C, 3, 3), (B, C, 3): unweighted
    residuals (B, C, F, 3), the detached weights (B, C, F), the camera-frame
    points and the clamped depths."""
    p_c = lie.se3_apply(R[:, :, None], t[:, :, None], w.p_w)       # (B, C, F, 3)
    uv_hat = cameras.project(w.cam_model, w.cam_params, p_c)
    z = p_c[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    r2 = uv_hat - w.uv
    r3 = torch.where(w.is_stereo, uv_hat[..., 0] - torch.full_like(zs, w.bf) / zs - w.u_right,
                     torch.zeros_like(zs))
    r_vis = torch.cat([r2, r3[..., None]], dim=-1)
    chi2 = torch.sum(r_vis * r_vis, dim=-1) * w.w_sig
    wt = (w.w_sig * huber_weight(chi2, w.delta) * w.obs_f
          * (1.0 - (z <= 0.05).to(z.dtype))).detach()
    return r_vis, wt, p_c, zs


def _residuals(w: Window, x):
    """The window's flat residual vector (B, m) at parameters x (B, n_par)."""
    B = x.shape[0]
    R, t, v, bg, ba = _unpack(w, x)
    r_vis, wt, _, _ = _visual(w, R, t)
    r_vis = (r_vis * torch.sqrt(wt)[..., None]).reshape(B, -1)

    Rwb, p = imu_mod.body_from_cam(R, t, w.R_bc, w.t_bc)
    bg_g = bg[:, :-1] if w.per_kf_bias else bg[:, None]
    ba_g = ba[:, :-1] if w.per_kf_bias else ba[:, None]
    r = imu_mod.inertial_residual(Rwb[:, :-1], v[:, :-1], p[:, :-1], Rwb[:, 1:], v[:, 1:],
                                  p[:, 1:], bg_g, ba_g, w.pres)
    r_imu = ((w.L9.transpose(-1, -2) @ r[..., None])[..., 0] * w.gap_ok[:, None]).reshape(B, -1)
    if w.per_kf_bias:
        # random walk between consecutive biases; a prior ties the first
        # one to the incoming estimate
        r_rw = torch.cat(
            [(w.Lbg_rw.transpose(-1, -2) @ (bg[:, 1:] - bg[:, :-1])[..., None])[..., 0],
             (w.Lba_rw.transpose(-1, -2) @ (ba[:, 1:] - ba[:, :-1])[..., None])[..., 0]],
            dim=-1) * w.gap_ok[:, None]
        r_bias = torch.cat([(bg[:, 0] - w.bg0) * 1e2 ** 0.5, (ba[:, 0] - w.ba0) * 1e1 ** 0.5,
                            r_rw.reshape(B, -1)], dim=-1)
    else:
        r_bias = torch.cat([(bg - w.bg0) * 1e2 ** 0.5, (ba - w.ba0) * 1e1 ** 0.5], dim=-1)
    return (torch.cat([r_vis, r_imu, r_bias], dim=-1),)


def local_inertial_ba(m: ms.MapState, window_ids, fixed_mask, pres: imu_mod.Preintegrated,
                      pre_valid, bg0, ba0, cam_params, bf: float,
                      cam_model: int = cameras.PINHOLE, n_iters: int = 8,
                      n_levels: int = 8, R_bc=None, t_bc=None, v_init=None,
                      v_init_valid=None, per_kf_bias: bool = False) -> VIWindowResult:
    """VI-BA over the keyframes `window_ids` (C,) (-1 pads), landmarks fixed.

    pres: the C - 1 consecutive gaps' preintegrations, stacked; pre_valid
    (C - 1,) masks gaps without IMU data. fixed_mask (C,) holds keyframes'
    poses (their velocities and biases stay free). R_bc / t_bc: the
    IMU-from-camera extrinsic (identity when None). v_init / v_init_valid:
    the keyframes' stored velocities (kf_v) and which to use; the others
    start in closed form. All index arguments are device tensors. The
    result's tensors are made by this call."""
    global evals_torch
    w = window_problem(m, window_ids, fixed_mask, pres, pre_valid, bg0, ba0, cam_params, bf,
                       cam_model=cam_model, n_levels=n_levels, R_bc=R_bc, t_bc=t_bc,
                       v_init=v_init, v_init_valid=v_init_valid, per_kf_bias=per_kf_bias)
    x = torch.zeros(w.n_par, dtype=m.kf_R.dtype, device=m.kf_R.device)
    if _fused(x.device, cam_model, per_kf_bias) and n_iters > 0:
        packed = cuda_vi.pack(w)
        for _ in range(n_iters):
            x, *state = cuda_vi.vi_step(packed, cuda_vi.vi_eval(packed, x), x)
        return VIWindowResult(*state)
    eye = torch.eye(w.n_par, dtype=x.dtype, device=x.device)
    for _ in range(n_iters):
        r, J, _ = jacobian_fwd(lambda y: _residuals(w, y), x)
        evals_torch += 1
        H = J.T @ J + 1e-5 * eye
        x = x - torch.linalg.solve_ex(H, J.T @ r)[0]
    R, t, v, bg, ba = (y[0] for y in _unpack(w, x[None]))
    return VIWindowResult(kf_R=R, kf_t=t, v=v, bg=bg, ba=ba)


# -- the kernels' plain version: normal equations from analytic Jacobians --

def _coeff_derivs(theta2, A, B, C):
    """d/d(theta^2) of lie._sin_cos_coeffs' B and C, branch by branch as
    they are computed (the series below theta^2 = 0.09)."""
    small = theta2 < lie._SERIES_THETA2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    dB = torch.where(small, -1.0 / 24.0 + theta2 * (2.0 / 720.0 - theta2 * 3.0 / 40320.0),
                     (A - 2.0 * B) / (2.0 * t2))
    dC = torch.where(small, -1.0 / 120.0 + theta2 * (2.0 / 5040.0 - theta2 * 3.0 / 362880.0),
                     (B - 3.0 * C) / (2.0 * t2))
    return dB, dC


def _se3_left_jacobian(xi):
    """(..., 6) [rho, phi] -> (..., 6, 6) M with exp(xi + d) ~ exp(M d)
    exp(xi): [[Jl, Q], [0, Jl]], Jl the SO(3) left Jacobian at phi and
    Q = d(Jl rho)/d phi + hat(Jl rho) Jl (the translation's response to phi,
    less the rotation of the translation itself)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    A, B, C = lie._sin_cos_coeffs(theta2)
    dB, dC = _coeff_derivs(theta2, A, B, C)
    W = lie.hat(phi)
    eye = lie._eye_like(W)
    Jl = eye + B[..., None, None] * W + C[..., None, None] * (W @ W)
    Jl_rho = lie._matvec(Jl, rho)
    pxr = torch.linalg.cross(phi, rho)
    ppr = torch.linalg.cross(phi, pxr)
    outer = lambda a, b: a[..., :, None] * b[..., None, :]   # noqa: E731
    dJ = (2.0 * dB[..., None, None] * outer(pxr, phi) - B[..., None, None] * lie.hat(rho)
          + 2.0 * dC[..., None, None] * outer(ppr, phi)
          + C[..., None, None] * (torch.sum(phi * rho, dim=-1)[..., None, None] * eye
                                  + outer(phi, rho) - 2.0 * outer(rho, phi)))
    Q = dJ + lie.hat(Jl_rho) @ Jl
    Z = torch.zeros_like(Jl)
    return torch.cat([torch.cat([Jl, Q], dim=-1), torch.cat([Z, Jl], dim=-1)], dim=-2)


def _so3_right_jacobian_inv(w):
    """lie.so3_right_jacobian_inv without its guard on sin(theta) (which
    moves the closed form by ~1e-8 at theta ~ 0.5): the exact derivative of
    lie.so3_log, which the forward-mode path differentiates."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < lie._SERIES_THETA2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    th = torch.sqrt(t2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 * (1.0 / 720.0 + theta2 * (
        1.0 / 30240.0 + theta2 / 1209600.0)),
                       1.0 / t2 - (1.0 + torch.cos(th)) / (2.0 * th * torch.sin(th)))
    W = lie.hat(w)
    return lie._eye_like(W) + 0.5 * W + coef[..., None, None] * (W @ W)


def _chart(w: Window, x):
    """(C, 15, 15): each keyframe's local perturbation [xi, dv, dbg, dba]
    per unit of its x-coordinates, the masks included."""
    xk = x.reshape(w.C, 15)
    M = _se3_left_jacobian(xk[:, :6] * w.free_pose) * w.free_pose[..., None]
    T = torch.zeros(w.C, 15, 15, dtype=x.dtype, device=x.device)
    T[:, :6, :6] = M
    T[:, 6:, 6:] = torch.eye(9, dtype=x.dtype, device=x.device) * w.free_vel[..., None]
    return T


def _visual_jacobian(w: Window, p_c, zs):
    """(C, F, 3, 6) the visual rows' unweighted Jacobians with respect to
    a left se(3) perturbation [nu, omega] of their keyframe's Tcw."""
    Jproj = cameras.project_jac(w.cam_model, w.cam_params, p_c)      # (C, F, 2, 3)
    dz = torch.zeros_like(p_c)
    dz[..., 2] = w.bf / (zs * zs)
    Jur = torch.where(w.is_stereo[..., None], Jproj[..., 0, :] + dz, torch.zeros_like(dz))
    Jfull = torch.cat([Jproj, Jur[..., None, :]], dim=-2)
    eye = lie._eye_like(lie.hat(p_c))
    return Jfull @ torch.cat([eye, -lie.hat(p_c)], dim=-1)


def _inertial_jacobian(w: Window, R, t, v, bg, ba):
    """Each gap's 15 rows (the whitened inertial edge, the two random
    walks; gap_ok applied) and their Jacobian (C - 1, 15, 30) in the local
    perturbations [nu, omega, dv, dbg, dba] of its two keyframes."""
    pre = w.pres
    mv, hat = lie._matvec, lie.hat
    Rwb, p = imu_mod.body_from_cam(R, t, w.R_bc, w.t_bc)
    R1, R2, p1, p2 = Rwb[:-1], Rwb[1:], p[:-1], p[1:]
    v1, v2 = v[:-1], v[1:]
    g_w = imu_mod.gravity_w(R)
    dt = pre.dt[:, None]
    dR, dV, dP = imu_mod.corrected_deltas(pre, bg[:-1], ba[:-1])
    phib = mv(pre.JRg, bg[:-1] - pre.bg)
    R1t = R1.transpose(-1, -2)
    E = dR.transpose(-1, -2) @ R1t @ R2
    er = lie.so3_log(E)
    Jri = _so3_right_jacobian_inv(er)
    av = mv(R1t, v2 - v1 - g_w * dt)
    ap = mv(R1t, p2 - p1 - v1 * dt - 0.5 * g_w * dt * dt)
    r9 = torch.cat([er, av - dV, ap - dP], dim=-1)

    Z = torch.zeros_like(R1)
    col = lambda a, b, c: torch.cat([a, b, c], dim=-2)             # noqa: E731
    # in the body states: right perturbations of R_wb, world p and v, biases
    d_th1 = col(-Jri @ R2.transpose(-1, -2) @ R1, hat(av), hat(ap))
    d_th2 = col(Jri, Z, Z)
    d_p1, d_p2 = col(Z, Z, -R1t), col(Z, Z, R1t)
    d_v1, d_v2 = col(Z, -R1t, -R1t * dt[..., None]), col(Z, R1t, Z)
    d_bg = col(-Jri @ E.transpose(-1, -2) @ lie.so3_right_jacobian(phib) @ pre.JRg,
               -pre.JVg, -pre.JPg)
    d_ba = col(Z, -pre.JVa, -pre.JPa)
    # through T_bc: a left [nu, omega] on Tcw moves R_wb by exp(-R_bc omega)
    # on the right and p_wb by -R_wc nu - R_wb hat(t_bc) R_bc omega
    Rwc = R.transpose(-1, -2)
    lever = Rwb @ hat(w.t_bc) @ w.R_bc                              # (C, 3, 3)
    d_nu1, d_nu2 = d_p1 @ -Rwc[:-1], d_p2 @ -Rwc[1:]
    d_om1 = d_th1 @ -w.R_bc + d_p1 @ -lever[:-1]
    d_om2 = d_th2 @ -w.R_bc + d_p2 @ -lever[1:]
    Z9 = col(Z, Z, Z)
    J9 = torch.cat([d_nu1, d_om1, d_v1, d_bg, d_ba, d_nu2, d_om2, d_v2, Z9, Z9], dim=-1)
    LT = w.L9.transpose(-1, -2)
    ok = w.gap_ok[:, None]
    r_imu = mv(LT, r9) * ok
    J_imu = (LT @ J9) * ok[..., None]
    Lg, La = w.Lbg_rw.transpose(-1, -2), w.Lba_rw.transpose(-1, -2)
    r_rw = torch.cat([mv(Lg, bg[1:] - bg[:-1]), mv(La, ba[1:] - ba[:-1])], dim=-1) * ok
    J_rw = torch.zeros(R1.shape[0], 6, 30, dtype=R.dtype, device=R.device)
    J_rw[:, :3, 9:12], J_rw[:, :3, 24:27] = -Lg, Lg
    J_rw[:, 3:, 12:15], J_rw[:, 3:, 27:30] = -La, La
    return (torch.cat([r_imu, r_rw], dim=-1),
            torch.cat([J_imu, J_rw * ok[..., None]], dim=-2))


def _normal_equations_torch(w: Window, x):
    """(H (n, n), g (n,)) = (J^T J + 1e-5 I, J^T r) of the window's
    residuals at x (n_par,) with per-keyframe biases, from the edges'
    analytic Jacobians: the plain version of the `vi_eval` and `vi_step`
    kernels, any device and dtype. Equal to what `jacobian_fwd` gives over
    `_residuals`, to rounding."""
    C, n = w.C, w.n_par
    R, t, v, bg, ba = (y[0] for y in _unpack(w, x[None]))
    T = _chart(w, x)
    H = torch.zeros(n, n, dtype=x.dtype, device=x.device)
    g = torch.zeros(n, dtype=x.dtype, device=x.device)

    r_vis, wt, p_c, zs = (y[0] for y in _visual(w, R[None], t[None]))
    Jv = _visual_jacobian(w, p_c, zs) @ T[:, None, :6, :6]           # (C, F, 3, 6)
    Jw = Jv * wt[..., None, None]
    Hv = torch.einsum("cfri,cfrj->cij", Jw, Jv)
    gv = torch.einsum("cfri,cfr->ci", Jw, r_vis)

    r_g, J_g = _inertial_jacobian(w, R, t, v, bg, ba)
    Tab = torch.zeros(C - 1, 30, 30, dtype=x.dtype, device=x.device)
    Tab[:, :15, :15], Tab[:, 15:, 15:] = T[:-1], T[1:]
    J_g = J_g @ Tab
    Hg = J_g.transpose(-1, -2) @ J_g
    gg = lie._matvec(J_g.transpose(-1, -2), r_g)

    for k in range(C):
        s = slice(15 * k, 15 * k + 6)
        H[s, s] += Hv[k]
        g[s] += gv[k]
    for k in range(C - 1):
        s = slice(15 * k, 15 * k + 30)
        H[s, s] += Hg[k]
        g[s] += gg[k]
    # the first keyframe's bias prior: sqrt-information 10 (gyro), sqrt(10)
    sq = torch.tensor([1e2 ** 0.5] * 3 + [1e1 ** 0.5] * 3, dtype=x.dtype, device=x.device)
    r_p = torch.cat([bg[0] - w.bg0, ba[0] - w.ba0]) * sq
    jp = sq * w.free_vel[0]
    H[9:15, 9:15] += torch.diag(jp * jp)
    g[9:15] += jp * r_p
    return H + 1e-5 * torch.eye(n, dtype=x.dtype, device=x.device), g


def apply_vi_window(m: ms.MapState, window_ids, fixed_mask, res: VIWindowResult) -> ms.MapState:
    """Write the window's result into the map, in place: the poses of the
    valid, free keyframes; the velocity and bias of every valid one (the
    keyframes carry their inertial state, KeyFrame.h:206-216).

    The reference scatters every window row, padding rows (-1, clipped to
    slot 0) writing slot 0's old values last; so when the window is padded
    and holds keyframe 0, keyframe 0 keeps its old values (the CPU's last
    write). Carried for parity: slot 0 is left alone whenever the window
    has padding."""
    ids = torch.clamp(window_ids, 0, m.max_kf - 1).long()
    cam_ok = (window_ids >= 0) & m.kf_valid[ids]
    keep0 = (ids == 0) & (window_ids < 0).any()
    ok = cam_ok & ~keep0
    upd = ok & ~fixed_mask
    bgs = res.bg.expand_as(res.v)
    bas = res.ba.expand_as(res.v)
    m.kf_R[ids] = torch.where(upd[:, None, None], res.kf_R, m.kf_R[ids])
    m.kf_t[ids] = torch.where(upd[:, None], res.kf_t, m.kf_t[ids])
    m.kf_v[ids] = torch.where(ok[:, None], res.v, m.kf_v[ids])
    m.kf_bg[ids] = torch.where(ok[:, None], bgs, m.kf_bg[ids])
    m.kf_ba[ids] = torch.where(ok[:, None], bas, m.kf_ba[ids])
    return m
