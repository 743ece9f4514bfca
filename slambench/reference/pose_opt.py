"""Motion-only pose optimisation: batched Gauss-Newton/LM on SE(3)
(port of `orbslam3lib_tpu/tracking/pose_opt.py`).

The reference's g2o PoseOptimization (Optimizer.cc:813-1120) as fixed-
capacity masked arrays: each iteration forms all residuals and Jacobians at
once, the 6x6 normal equations by one reduction, and a closed 6x6 solve.
Between rounds the chi2 outlier classification is redone (5.991 mono /
7.815 stereo); outliers leave the next round's normal equations but are
re-tested every round. The rounds and iterations are a Python loop (the
reference's fori_loop/scan). `classify`, where given, makes each round's
classification: it gets the round, the chi2 and behind flags, the gates and
the solve's own decision, and returns the decision to keep.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, lie
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class PoseObs(NamedTuple):
    """Fixed-capacity observation set for one frame's pose solve.

    p_world (N, 3), uv (N, 2) measured left pixels, inv_sigma2 (N,),
    u_right (N,) measured right u of rectified stereo observations (else 0),
    is_stereo (N,) bool, valid (N,) bool.
    """
    p_world: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    u_right: torch.Tensor
    is_stereo: torch.Tensor
    valid: torch.Tensor


def _residuals_jacobians(R, t, obs: PoseObs, cam_model: int, cam_params, bf):
    """Residuals r (N, 3), Jacobians J (N, 3, 6), chi2 (N,), behind (N,).

    Mono rows use the first two residual components; stereo adds the right-u
    residual u - bf/z. Left-multiplicative update xi = [rho, phi]:
    d(p_c)/d(xi) = [I | -hat(p_c)].
    """
    p_c = lie.se3_apply(R, t, obs.p_world)
    uv_hat = cameras.project(cam_model, cam_params, p_c)
    z = p_c[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u_r_hat = uv_hat[..., 0] - bf / z_safe

    r2 = uv_hat - obs.uv
    r3 = torch.where(obs.is_stereo, u_r_hat - obs.u_right, torch.zeros_like(z))
    r = torch.cat([r2, r3[..., None]], dim=-1)

    Jproj = cameras.project_jac(cam_model, cam_params, p_c)
    dz = torch.zeros_like(p_c)
    dz[..., 2] = 1.0
    Jur = Jproj[..., 0, :] + (bf / (z_safe * z_safe))[..., None] * dz
    Jur = torch.where(obs.is_stereo[..., None], Jur, torch.zeros_like(Jur))
    Jfull = torch.cat([Jproj, Jur[..., None, :]], dim=-2)

    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(p_c.shape[:-1] + (3, 3))
    Dp = torch.cat([eye, -lie.hat(p_c)], dim=-1)
    J = Jfull @ Dp

    behind = z <= 0.05
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    return r, J, chi2, behind


def pose_optimization(R0, t0, obs: PoseObs, cam_params,
                      cam_model: int = cameras.PINHOLE, bf: float = 0.0,
                      n_rounds: int = 4, iters_per_round: int = 10,
                      lm_lambda: float = 1e-3, classify=None):
    """Optimise Tcw from 3D-2D matches. Returns (R, t, inlier_mask,
    n_inliers), n_inliers a 0-d int32 tensor."""
    chi2_th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO)
    dev, dt = R0.device, R0.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    valid_f = obs.valid.to(dt)

    R, t = R0, t0
    inlier = torch.ones(obs.valid.shape, dtype=dt, device=dev)
    for k in range(n_rounds):
        for _ in range(iters_per_round):
            r, J, chi2, behind = _residuals_jacobians(R, t, obs, cam_model,
                                                      cam_params, bf)
            w = obs.inv_sigma2 * huber_weight(chi2, delta) * inlier * valid_f \
                * (~behind).to(dt)
            Jw = J * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", Jw, J)
            b = torch.einsum("nri,nr->i", Jw, r)
            H = H + lm_lambda * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            # solve_ex: no singularity check, which would wait for the card
            dx = -torch.linalg.solve_ex(H, b)[0]
            dR, dtr = lie.se3_exp(dx)
            R, t = lie.se3_compose(dR, dtr, R, t)
            R = lie.normalize_rotation(R)
        _, _, chi2, behind = _residuals_jacobians(R, t, obs, cam_model,
                                                  cam_params, bf)
        own = (chi2 <= chi2_th) & ~behind
        if classify is not None:
            own = classify(k, chi2, behind, chi2_th, own)
        inlier = own.to(dt)
    inlier_mask = (inlier > 0) & obs.valid
    return R, t, inlier_mask, torch.sum(inlier_mask.to(torch.int32))
