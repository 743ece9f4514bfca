"""Bundle adjustment: batched Levenberg-Marquardt with a dense Schur
complement (port of `orbslam3lib_tpu/mapping/local_ba.py`).

The reference's g2o local BA (Optimizer.cc:1124) as fixed-shape masked
arrays: per iteration, residuals and Jacobians of all edges in one batched
pass, scattered (`index_add_`) into the camera blocks H_cc (C, 6, 6), the
landmark blocks H_pp (P, 3, 3) and a dense coupling W (P, C, 6, 3); the
reduced camera system S = H_cc - sum_p W_p H_pp^-1 W_p^T is solved by LU
(`torch.linalg.solve_ex`, which leaves `info` on the device instead of
checking it on the host every iteration), landmarks by back-substitution
with closed-form 3x3 inverses. Fixed and invalid cameras/points get identity
blocks and zero couplings, so their deltas are exactly zero.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import cameras, lie
from ..utils.robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight
from ..utils.smallmat import inv3


class BAProblem(NamedTuple):
    """Fixed-shape BA problem.

    cam_R (C, 3, 3) world->cam, cam_t (C, 3), cam_fixed (C,) bool (pose held
    constant), cam_valid (C,) bool, points (P, 3), pt_valid (P,) bool;
    per edge: e_cam (E,) camera index, e_pt (E,) point index, e_uv (E, 2),
    e_inv_sigma2 (E,), e_u_right (E,), e_stereo (E,) bool, e_valid (E,) bool.
    """
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


def _edge_terms(prob: BAProblem, cam_model: int, cam_params, bf):
    """Residuals r (E, 3), Jacobians Jc (E, 3, 6), Jp (E, 3, 3), chi2 (E,),
    behind (E,)."""
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

    Jproj = cameras.project_jac(cam_model, cam_params, p_c)      # (E, 2, 3)
    dz = torch.zeros_like(p_c)
    dz[..., 2] = 1.0
    Jur = Jproj[..., 0, :] + (bf / (z_safe * z_safe))[..., None] * dz
    Jur = torch.where(prob.e_stereo[..., None], Jur, torch.zeros_like(Jur))
    Jfull = torch.cat([Jproj, Jur[..., None, :]], dim=-2)        # d r / d p_c

    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(p_c.shape[:-1] + (3, 3))
    Dp_xi = torch.cat([eye, -lie.hat(p_c)], dim=-1)              # (E, 3, 6)
    Jc = Jfull @ Dp_xi
    Jp = Jfull @ R                                               # d p_c / d p_w = R

    behind = z <= 0.05
    chi2 = torch.sum(r * r, dim=-1) * prob.e_inv_sigma2
    return r, Jc, Jp, chi2, behind


def _build_normal_eq(prob: BAProblem, r, Jc, Jp, w):
    """Scatter the edge terms into (H_cc, H_pp, W, b_c, b_p)."""
    C = prob.cam_R.shape[0]
    P = prob.points.shape[0]
    e_cam, e_pt = prob.e_cam.long(), prob.e_pt.long()
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]

    def seg(x, ids, n):
        return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                           device=x.device).index_add_(0, ids, x)

    Hcc = seg(torch.einsum("eri,erj->eij", wJc, Jc), e_cam, C)
    Hpp = seg(torch.einsum("eri,erj->eij", wJp, Jp), e_pt, P)
    b_c = seg(torch.einsum("eri,er->ei", wJc, r), e_cam, C)
    b_p = seg(torch.einsum("eri,er->ei", wJp, r), e_pt, P)
    # dense (P, C, 6, 3) coupling through the combined segment id
    W = seg(torch.einsum("eri,erj->eij", wJc, Jp), e_pt * C + e_cam,
            P * C).reshape(P, C, 6, 3)
    return Hcc, Hpp, W, b_c, b_p


def _schur_solve(Hcc, Hpp, W, b_c, b_p, free_cam, free_pt, lm_lambda: float):
    """Solve the damped normal equations by Schur complement. free_cam (C,)
    and free_pt (P,) are float masks, 1 = optimise."""
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

    # LM damping H + lambda * diag(H), plus a small absolute floor
    Hcc = Hcc + lm_lambda * Hcc * I6 + 1e-8 * I6
    Hpp = Hpp + lm_lambda * Hpp * I3 + 1e-8 * I3
    Hpp_inv = inv3(Hpp)

    WHinv = torch.einsum("pcia,pab->pcib", W, Hpp_inv)           # (P, C, 6, 3)
    S_off = torch.einsum("pcia,pdja->cidj", WHinv, W)            # (C, 6, C, 6)
    eyeC = torch.eye(C, dtype=Hcc.dtype, device=Hcc.device)
    S = (torch.einsum("cij,cd->cidj", Hcc, eyeC) - S_off).reshape(C * 6, C * 6)

    b_schur = b_c - torch.einsum("pcia,pa->ci", WHinv, b_p)      # (C, 6)
    dx_c = -torch.linalg.solve_ex(S, b_schur.reshape(-1))[0].reshape(C, 6)

    # back-substitution: dx_p = -Hpp_inv (b_p + W^T dx_c)
    Wt_dxc = torch.einsum("pcia,ci->pa", W, dx_c)
    dx_p = -torch.einsum("pab,pb->pa", Hpp_inv, b_p + Wt_dxc)
    return dx_c * free_cam[:, None], dx_p * free_pt[:, None]


def bundle_adjust(prob: BAProblem, cam_params, cam_model: int = cameras.PINHOLE,
                  bf: float = 0.0, n_iters: int = 10, lm_lambda: float = 1e-4,
                  chi2_gate_after: int = 5):
    """Run LM BA. Returns (cam_R, cam_t, points, edge_inlier_mask).

    LocalBundleAdjustment's two-phase schedule (Optimizer.cc:1350+): from
    iteration `chi2_gate_after` on, edges failing the chi2 gate (or behind
    the camera) after the update leave the following iterations.
    """
    dtype = prob.cam_R.dtype
    chi2_th = torch.where(prob.e_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.where(prob.e_stereo, DELTA_STEREO, DELTA_MONO)
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
            # the gate reads the updated state
            p2 = prob._replace(cam_R=cam_R, cam_t=cam_t, points=points)
            _, _, _, chi2n, behindn = _edge_terms(p2, cam_model, cam_params, bf)
            inlier = ((chi2n <= chi2_th) & ~behindn).to(dtype)
    return cam_R, cam_t, points, (inlier > 0) & e_base_valid
