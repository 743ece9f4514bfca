"""The keyframe back end's two window solves (port of the port's
`mapping/local_ba.py`, the window gather of `mapping/map_ba.py`, and
`mapping/vi_ba.local_inertial_ba`), in the dtype of their inputs.

- `window_ba`: LocalBundleAdjustment (Optimizer.cc:1124) over a keyframe
  window, the anchors fixed and every landmark the window sees free:
  Levenberg-Marquardt on the Schur complement, Huber weights, and from the
  sixth iteration the chi2 gate on the updated state.
- `vi_window`: LocalInertialBA (Optimizer.cc:2405) over the window's poses,
  velocities and biases (per keyframe, or one shared), the landmarks held:
  Gauss-Newton on one flat residual vector with its Jacobian by
  forward-mode AD.

A map is any object with the `MAP_FIELDS` tensors and the sizes `max_kf`,
`max_mp` and `n_feat`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, lie
from .fast import topk_stable
from .imu import Pre, body_from_cam, gravity_w, inertial_residual
from .inertial_opt import closed_form_velocities, jacobian_fwd, sqrt_info
from .pyramid import scale_factors_on
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight
from .smallmat import inv3

MAP_FIELDS = ("kf_valid", "kf_feat_valid", "kf_mp", "kf_xy", "kf_level", "kf_depth",
              "kf_R", "kf_t", "mp_valid", "mp_pos")


def inv_sigma2(level: torch.Tensor, n_levels: int = 8) -> torch.Tensor:
    sf = scale_factors_on(n_levels, level.device)
    s = sf[torch.clamp(level, 0, n_levels - 1).long()]
    return 1.0 / (s * s)


class BAProblem(NamedTuple):
    cam_R: torch.Tensor
    cam_t: torch.Tensor
    cam_fixed: torch.Tensor
    cam_valid: torch.Tensor
    points: torch.Tensor
    pt_valid: torch.Tensor
    e_cam: torch.Tensor
    e_pt: torch.Tensor
    e_uv: torch.Tensor
    e_inv_sigma2: torch.Tensor
    e_u_right: torch.Tensor
    e_stereo: torch.Tensor
    e_valid: torch.Tensor


def _gather_window_problem(m, window_ids, fixed_mask, bf: float, n_ba_points: int):
    C = window_ids.shape[0]
    F = m.n_feat
    P = m.max_mp
    dev = window_ids.device
    ids = torch.clamp(window_ids, 0, m.max_kf - 1).long()
    cam_ok = (window_ids >= 0) & m.kf_valid[ids]
    kf_mp_w = torch.where(cam_ok[:, None] & m.kf_feat_valid[ids], m.kf_mp[ids], -1)
    flat = kf_mp_w.reshape(-1)
    flag = torch.zeros(P, device=dev).scatter_reduce(
        0, torch.clamp(flat, 0, P - 1).long(), (flat >= 0).to(torch.float32),
        reduce="amax")
    flag = flag * m.mp_valid.to(torch.float32)
    sel_flag, sel_ids = topk_stable(flag, n_ba_points)
    pt_ok = sel_flag > 0
    inv = torch.full((P,), -1, dtype=torch.int64, device=dev)
    inv[sel_ids] = torch.arange(n_ba_points, device=dev)
    e_pt = inv[torch.clamp(flat, 0, P - 1).long()]
    e_valid = (flat >= 0) & (e_pt >= 0)
    e_cam = torch.arange(C, device=dev).repeat_interleave(F)
    e_uv = m.kf_xy[ids].reshape(-1, 2)
    e_level = m.kf_level[ids].reshape(-1)
    e_depth = m.kf_depth[ids].reshape(-1)
    e_stereo = e_depth > 0.05
    z_safe = torch.clamp(e_depth, min=0.05)
    e_u_right = torch.where(e_stereo, e_uv[:, 0] - bf / z_safe, torch.zeros_like(z_safe))
    prob = BAProblem(
        cam_R=m.kf_R[ids], cam_t=m.kf_t[ids],
        cam_fixed=fixed_mask | ~cam_ok, cam_valid=cam_ok,
        points=m.mp_pos[sel_ids], pt_valid=pt_ok,
        e_cam=e_cam, e_pt=torch.where(e_valid, e_pt, 0),
        e_uv=e_uv, e_inv_sigma2=inv_sigma2(e_level, 8).to(e_uv.dtype),
        e_u_right=e_u_right, e_stereo=e_stereo, e_valid=e_valid)
    return prob, cam_ok


def _edge_terms(prob: BAProblem, cam_model: int, cam_params, bf):
    e_cam, e_pt = prob.e_cam.long(), prob.e_pt.long()
    R = prob.cam_R[e_cam]
    t = prob.cam_t[e_cam]
    p_c = lie.se3_apply(R, t, prob.points[e_pt])
    uv_hat = cameras.project(cam_model, cam_params, p_c)
    z = p_c[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    r2 = uv_hat - prob.e_uv
    u_r_hat = uv_hat[..., 0] - bf / z_safe
    r3 = torch.where(prob.e_stereo, u_r_hat - prob.e_u_right, torch.zeros_like(z))
    r = torch.cat([r2, r3[..., None]], dim=-1)
    Jproj = cameras.project_jac(cam_model, cam_params, p_c)
    dz = torch.zeros_like(p_c)
    dz[..., 2] = 1.0
    Jur = Jproj[..., 0, :] + (bf / (z_safe * z_safe))[..., None] * dz
    Jur = torch.where(prob.e_stereo[..., None], Jur, torch.zeros_like(Jur))
    Jfull = torch.cat([Jproj, Jur[..., None, :]], dim=-2)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(p_c.shape[:-1] + (3, 3))
    Dp_xi = torch.cat([eye, -lie.hat(p_c)], dim=-1)
    Jc = Jfull @ Dp_xi
    Jp = Jfull @ R
    behind = z <= 0.05
    chi2 = torch.sum(r * r, dim=-1) * prob.e_inv_sigma2
    return r, Jc, Jp, chi2, behind


def _build_normal_eq(prob: BAProblem, r, Jc, Jp, w):
    C = prob.cam_R.shape[0]
    P = prob.points.shape[0]
    e_cam, e_pt = prob.e_cam.long(), prob.e_pt.long()
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]

    def seg(x, ids, n):
        out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
        return out.index_add_(0, ids, x)

    Hcc = seg(torch.einsum("eri,erj->eij", wJc, Jc), e_cam, C)
    Hpp = seg(torch.einsum("eri,erj->eij", wJp, Jp), e_pt, P)
    b_c = seg(torch.einsum("eri,er->ei", wJc, r), e_cam, C)
    b_p = seg(torch.einsum("eri,er->ei", wJp, r), e_pt, P)
    W = seg(torch.einsum("eri,erj->eij", wJc, Jp), e_pt * C + e_cam,
            P * C).reshape(P, C, 6, 3)
    return Hcc, Hpp, W, b_c, b_p


def _schur_solve(Hcc, Hpp, W, b_c, b_p, free_cam, free_pt, lm_lambda: float):
    C = Hcc.shape[0]
    I6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    I3 = torch.eye(3, dtype=Hcc.dtype, device=Hcc.device)
    fc = free_cam[:, None, None]
    fp = free_pt[:, None, None]
    Hcc = fc * Hcc + (1 - fc) * I6
    Hpp = fp * Hpp + (1 - fp) * I3
    W = W * free_cam[None, :, None, None] * free_pt[:, None, None, None]
    b_c = b_c * free_cam[:, None]
    b_p = b_p * free_pt[:, None]
    Hcc = Hcc + lm_lambda * Hcc * I6 + 1e-8 * I6
    Hpp = Hpp + lm_lambda * Hpp * I3 + 1e-8 * I3
    Hpp_inv = inv3(Hpp)
    WHinv = torch.einsum("pcia,pab->pcib", W, Hpp_inv)
    S_off = torch.einsum("pcia,pdja->cidj", WHinv, W)
    eyeC = torch.eye(C, dtype=Hcc.dtype, device=Hcc.device)
    S = (torch.einsum("cij,cd->cidj", Hcc, eyeC) - S_off).reshape(C * 6, C * 6)
    b_schur = b_c - torch.einsum("pcia,pa->ci", WHinv, b_p)
    dx_c = -torch.linalg.solve_ex(S, b_schur.reshape(-1))[0].reshape(C, 6)
    Wt_dxc = torch.einsum("pcia,ci->pa", W, dx_c)
    dx_p = -torch.einsum("pab,pb->pa", Hpp_inv, b_p + Wt_dxc)
    return dx_c * free_cam[:, None], dx_p * free_pt[:, None]


def bundle_adjust(prob: BAProblem, cam_params, cam_model: int, bf: float, n_iters: int,
                  lm_lambda: float = 1e-4, chi2_gate_after: int = 5):
    dtype = prob.cam_R.dtype
    chi2_th = torch.where(prob.e_stereo, CHI2_STEREO, CHI2_MONO).to(dtype)
    delta = torch.where(prob.e_stereo, DELTA_STEREO, DELTA_MONO).to(dtype)
    free_cam = (prob.cam_valid & ~prob.cam_fixed).to(dtype)
    free_pt = prob.pt_valid.to(dtype)
    e_base_valid = (prob.e_valid & prob.cam_valid[prob.e_cam.long()]
                    & prob.pt_valid[prob.e_pt.long()])
    cam_R, cam_t, points = prob.cam_R, prob.cam_t, prob.points
    inlier = torch.ones(prob.e_valid.shape, dtype=dtype, device=cam_R.device)
    for it in range(n_iters):
        p = prob._replace(cam_R=cam_R, cam_t=cam_t, points=points)
        r, Jc, Jp, chi2, behind = _edge_terms(p, cam_model, cam_params, bf)
        w = prob.e_inv_sigma2 * huber_weight(chi2, delta) * inlier * e_base_valid * ~behind
        Hcc, Hpp, W, b_c, b_p = _build_normal_eq(p, r, Jc, Jp, w)
        dx_c, dx_p = _schur_solve(Hcc, Hpp, W, b_c, b_p, free_cam, free_pt, lm_lambda)
        dR, dt = lie.se3_exp(dx_c)
        cam_R, cam_t = lie.se3_compose(dR, dt, cam_R, cam_t)
        cam_R = lie.normalize_rotation(cam_R)
        points = points + dx_p
        if it >= chi2_gate_after:
            p2 = prob._replace(cam_R=cam_R, cam_t=cam_t, points=points)
            _, _, _, chi2n, behindn = _edge_terms(p2, cam_model, cam_params, bf)
            inlier = ((chi2n <= chi2_th) & ~behindn).to(dtype)
    return cam_R, cam_t


def window_ba(m, window_ids, fixed_mask, cam_params, bf: float, cam_model: int,
              n_ba_points: int, n_iters: int):
    """The window's keyframe poses after the BA (C, 3, 3), (C, 3), and which
    of them the BA moves (valid and not fixed)."""
    prob, cam_ok = _gather_window_problem(m, window_ids, fixed_mask, bf, n_ba_points)
    cam_R, cam_t = bundle_adjust(prob, cam_params, cam_model, bf, n_iters)
    return cam_R, cam_t, cam_ok & ~fixed_mask


def vi_window(m, window_ids, fixed_mask, pres: Pre, pre_valid, bg0, ba0, cam_params, bf: float,
              cam_model: int, n_iters: int, n_levels: int, R_bc, t_bc, v_init, v_init_valid,
              per_kf_bias: bool):
    """The window's (R, t, v, bg, ba) after the VI-BA, and which keyframes
    are valid (their velocity and bias are free) and which not fixed (their
    pose is free)."""
    dt_ = m.kf_R.dtype
    C = window_ids.shape[0]
    ids = torch.clamp(window_ids, 0, m.max_kf - 1).long()
    cam_ok = (window_ids >= 0) & m.kf_valid[ids]
    kf_mp_raw = m.kf_mp[ids]
    kf_mp = torch.clamp(kf_mp_raw, 0, m.max_mp - 1).long()
    obs_ok = cam_ok[:, None] & m.kf_feat_valid[ids] & (kf_mp_raw >= 0) & m.mp_valid[kf_mp]
    p_w = m.mp_pos[kf_mp]
    uv = m.kf_xy[ids]
    w_sig = inv_sigma2(m.kf_level[ids], n_levels).to(dt_)
    depth = m.kf_depth[ids]
    is_stereo = obs_ok & (depth > 0.05)
    z_safe = torch.clamp(depth, min=0.05)
    u_right = torch.where(is_stereo, uv[..., 0] - torch.full_like(z_safe, bf) / z_safe,
                          torch.zeros_like(z_safe))
    delta = torch.where(is_stereo, DELTA_STEREO, DELTA_MONO).to(dt_)
    obs_f = obs_ok.to(dt_)

    R0, t0 = m.kf_R[ids], m.kf_t[ids]
    Rwb0, p0 = body_from_cam(R0, t0, R_bc, t_bc)
    g_w = gravity_w(R0)
    v_cf = closed_form_velocities(Rwb0, p0, pres, bg0, ba0, g_w)
    v0 = torch.where((v_init_valid & cam_ok)[:, None], v_init, v_cf)

    L9 = sqrt_info(pres.cov, 1e-8)
    gap_ok = (pre_valid & cam_ok[:-1] & cam_ok[1:]).to(dt_)
    free_pose = (cam_ok & ~fixed_mask).to(dt_)[:, None]
    free_vel = cam_ok.to(dt_)[:, None]
    n_par = 15 * C if per_kf_bias else 9 * C + 6
    if per_kf_bias:
        Lbg_rw = sqrt_info(pres.cov_bias[:, :3, :3], 1e-4)
        Lba_rw = sqrt_info(pres.cov_bias[:, 3:, 3:], 1e-2)

    def unpack(x):
        B = x.shape[0]
        if per_kf_bias:
            dkf = x.reshape(B, C, 15)
            bg = bg0 + dkf[..., 9:12] * free_vel
            ba = ba0 + dkf[..., 12:15] * free_vel
        else:
            dkf = x[:, :9 * C].reshape(B, C, 9)
            bg = bg0 + x[:, 9 * C:9 * C + 3]
            ba = ba0 + x[:, 9 * C + 3:]
        dR, dt = lie.se3_exp(dkf[..., :6] * free_pose)
        R, t = lie.se3_compose(dR, dt, R0, t0)
        return lie.normalize_rotation(R), t, v0 + dkf[..., 6:9] * free_vel, bg, ba

    def residuals(x):
        B = x.shape[0]
        R, t, v, bg, ba = unpack(x)
        p_c = lie.se3_apply(R[:, :, None], t[:, :, None], p_w)
        uv_hat = cameras.project(cam_model, cam_params, p_c)
        z = p_c[..., 2]
        zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        r2 = uv_hat - uv
        r3 = torch.where(is_stereo, uv_hat[..., 0] - torch.full_like(zs, bf) / zs - u_right,
                         torch.zeros_like(zs))
        r_vis = torch.cat([r2, r3[..., None]], dim=-1)
        chi2 = torch.sum(r_vis * r_vis, dim=-1) * w_sig
        w = (w_sig * huber_weight(chi2, delta) * obs_f * (1.0 - (z <= 0.05).to(dt_))).detach()
        r_vis = (r_vis * torch.sqrt(w)[..., None]).reshape(B, -1)
        Rwb, p = body_from_cam(R, t, R_bc, t_bc)
        bg_g = bg[:, :-1] if per_kf_bias else bg[:, None]
        ba_g = ba[:, :-1] if per_kf_bias else ba[:, None]
        r = inertial_residual(Rwb[:, :-1], v[:, :-1], p[:, :-1], Rwb[:, 1:], v[:, 1:],
                              p[:, 1:], bg_g, ba_g, pres)
        r_imu = ((L9.transpose(-1, -2) @ r[..., None])[..., 0] * gap_ok[:, None]).reshape(B, -1)
        if per_kf_bias:
            r_rw = torch.cat(
                [(Lbg_rw.transpose(-1, -2) @ (bg[:, 1:] - bg[:, :-1])[..., None])[..., 0],
                 (Lba_rw.transpose(-1, -2) @ (ba[:, 1:] - ba[:, :-1])[..., None])[..., 0]],
                dim=-1) * gap_ok[:, None]
            r_bias = torch.cat([(bg[:, 0] - bg0) * 1e2 ** 0.5, (ba[:, 0] - ba0) * 1e1 ** 0.5,
                                r_rw.reshape(B, -1)], dim=-1)
        else:
            r_bias = torch.cat([(bg - bg0) * 1e2 ** 0.5, (ba - ba0) * 1e1 ** 0.5], dim=-1)
        return (torch.cat([r_vis, r_imu, r_bias], dim=-1),)

    x = torch.zeros(n_par, dtype=dt_, device=R0.device)
    eye = torch.eye(n_par, dtype=dt_, device=R0.device)
    for _ in range(n_iters):
        r, J, _ = jacobian_fwd(residuals, x)
        H = J.T @ J + 1e-5 * eye
        x = x - torch.linalg.solve_ex(H, J.T @ r)[0]
    R, t, v, bg, ba = (y[0] for y in unpack(x[None]))
    return (R, t, v, bg.expand_as(v), ba.expand_as(v)), cam_ok, cam_ok & ~fixed_mask
