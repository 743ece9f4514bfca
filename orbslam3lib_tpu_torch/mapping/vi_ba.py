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
its dense Jacobian by forward-mode AD over all parameters in one pass
(`inertial_opt.jacobian_fwd`), `n_iters` Gauss-Newton steps
(J^T J + 1e-5 I) solved by `solve_ex`, in a Python loop. Nothing reads the
card. At the full VI pass's 24 keyframes that is 360 parameters over
24 * F * 3 visual rows; chip_smoke's phase I prints each call's device time
and peak memory.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import map_state as ms
from ..tracking import imu as imu_mod
from ..tracking.inertial_opt import closed_form_velocities, jacobian_fwd, sqrt_info
from ..utils import cameras, lie
from ..utils.robust import DELTA_MONO, DELTA_STEREO, huber_weight
from .map_ba import inv_sigma2


class VIWindowResult(NamedTuple):
    kf_R: torch.Tensor   # (C, 3, 3) window poses
    kf_t: torch.Tensor   # (C, 3)
    v: torch.Tensor      # (C, 3) world velocities
    bg: torch.Tensor     # (3,) the window's gyro bias, or (C, 3) per keyframe
    ba: torch.Tensor     # (3,) or (C, 3)


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
    start in closed form. All index arguments are device tensors."""
    dev = m.kf_R.device
    f32 = torch.float32
    R_bc = torch.eye(3, dtype=f32, device=dev) if R_bc is None else R_bc
    t_bc = torch.zeros(3, dtype=f32, device=dev) if t_bc is None else t_bc
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
    obs_f = obs_ok.to(f32)

    R0, t0 = m.kf_R[ids], m.kf_t[ids]
    Rwb0, p0 = imu_mod.body_from_cam(R0, t0, R_bc, t_bc)
    g_w = imu_mod.gravity_w(R0)
    v_cf = closed_form_velocities(Rwb0, p0, pres, bg0, ba0, g_w)
    if v_init is None:
        v0 = v_cf
    else:
        v0 = torch.where((v_init_valid & cam_ok)[:, None], v_init, v_cf)

    L9 = sqrt_info(pres.cov, 1e-8)                                 # (C-1, 9, 9)
    gap_ok = (pre_valid & cam_ok[:-1] & cam_ok[1:]).to(f32)
    # anchors hold their pose; every valid keyframe's velocity stays free
    free_pose = (cam_ok & ~fixed_mask).to(f32)[:, None]
    free_vel = cam_ok.to(f32)[:, None]
    n_par = 15 * C if per_kf_bias else 9 * C + 6
    if per_kf_bias:
        # EdgeGyroRW / EdgeAccRW: each gap's inverse accumulated walk
        # covariance
        Lbg_rw = sqrt_info(pres.cov_bias[:, :3, :3], 1e-4)         # (C-1, 3, 3)
        Lba_rw = sqrt_info(pres.cov_bias[:, 3:, 3:], 1e-2)

    def unpack(x):
        """x (B, n_par) -> poses (B, C, 3, 3), (B, C, 3), velocities (B, C, 3)
        and biases (B, C, 3) per keyframe or (B, 3) shared."""
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
        p_c = lie.se3_apply(R[:, :, None], t[:, :, None], p_w)     # (B, C, F, 3)
        uv_hat = cameras.project(cam_model, cam_params, p_c)
        z = p_c[..., 2]
        zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        r2 = uv_hat - uv
        r3 = torch.where(is_stereo, uv_hat[..., 0] - torch.full_like(zs, bf) / zs - u_right,
                         torch.zeros_like(zs))
        r_vis = torch.cat([r2, r3[..., None]], dim=-1)
        chi2 = torch.sum(r_vis * r_vis, dim=-1) * w_sig
        w = (w_sig * huber_weight(chi2, delta) * obs_f * (1.0 - (z <= 0.05).to(f32))).detach()
        r_vis = (r_vis * torch.sqrt(w)[..., None]).reshape(B, -1)

        Rwb, p = imu_mod.body_from_cam(R, t, R_bc, t_bc)
        bg_g = bg[:, :-1] if per_kf_bias else bg[:, None]
        ba_g = ba[:, :-1] if per_kf_bias else ba[:, None]
        r = imu_mod.inertial_residual(Rwb[:, :-1], v[:, :-1], p[:, :-1], Rwb[:, 1:], v[:, 1:],
                                      p[:, 1:], bg_g, ba_g, pres)
        r_imu = ((L9.transpose(-1, -2) @ r[..., None])[..., 0] * gap_ok[:, None]).reshape(B, -1)
        if per_kf_bias:
            # random walk between consecutive biases; a prior ties the first
            # one to the incoming estimate
            r_rw = torch.cat(
                [(Lbg_rw.transpose(-1, -2) @ (bg[:, 1:] - bg[:, :-1])[..., None])[..., 0],
                 (Lba_rw.transpose(-1, -2) @ (ba[:, 1:] - ba[:, :-1])[..., None])[..., 0]],
                dim=-1) * gap_ok[:, None]
            r_bias = torch.cat([(bg[:, 0] - bg0) * 1e2 ** 0.5, (ba[:, 0] - ba0) * 1e1 ** 0.5,
                                r_rw.reshape(B, -1)], dim=-1)
        else:
            r_bias = torch.cat([(bg - bg0) * 1e2 ** 0.5, (ba - ba0) * 1e1 ** 0.5], dim=-1)
        return (torch.cat([r_vis, r_imu, r_bias], dim=-1),)

    x = torch.zeros(n_par, dtype=f32, device=dev)
    eye = torch.eye(n_par, dtype=f32, device=dev)
    for _ in range(n_iters):
        r, J, _ = jacobian_fwd(residuals, x)
        H = J.T @ J + 1e-5 * eye
        x = x - torch.linalg.solve_ex(H, J.T @ r)[0]
    R, t, v, bg, ba = (y[0] for y in unpack(x[None]))
    return VIWindowResult(kf_R=R, kf_t=t, v=v, bg=bg, ba=ba)


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
