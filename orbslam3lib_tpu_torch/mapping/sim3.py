"""Sim(3) between keyframes: closed-form Horn, batched RANSAC, Gauss-Newton
refinement (port of `orbslam3lib_tpu/mapping/sim3.py`).

The reference's Sim3Solver (Sim3Solver.cc: 3-point Horn with scale inside a
sequential RANSAC, checked by reprojection in both cameras) as one batched
hypothesis sweep, and Optimizer::OptimizeSim3 (Optimizer.cc:2134:
bidirectional reprojection, Huber, chi2 gate 10) as a 7-dof GN whose
Jacobian is forward-mode AD of the residual
(`lie.value_and_rowwise_jacobian`), as
the reference's `jax.jacfwd`. Nothing here reads a value back to the host.
"""
from __future__ import annotations

import math

import torch

from ..utils import cameras, lie
from ..utils.robust import huber_weight
from ..utils.sampling import ransac_indices
from ..utils.smallmat import det3


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor,
              fix_scale: bool = False):
    """Weighted Horn/Umeyama, batched over leading dims: (R12, t12, s12)
    minimising sum w |p1 - (s R p2 + t)|^2. p1, p2 (..., N, 3), w (..., N).

    U S Vt of the 3x3 covariance differ in sign between LAPACK and
    cuSOLVER; R = U diag(1, 1, det(U Vt)) Vt does not."""
    wsum = torch.clamp(w.sum(dim=-1), min=1e-9)
    mu1 = torch.einsum("...n,...ni->...i", w, p1) / wsum[..., None]
    mu2 = torch.einsum("...n,...ni->...i", w, p2) / wsum[..., None]
    x1 = p1 - mu1[..., None, :]
    x2 = p2 - mu2[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, x1, x2) / wsum[..., None, None]
    U, D, Vt = torch.linalg.svd(cov)
    ones = torch.ones_like(D[..., 0])
    S = torch.stack([ones, ones, det3(U @ Vt)], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    var2 = torch.einsum("...n,...ni->...", w, x2 * x2) / wsum
    if fix_scale:
        s = ones
    else:
        s = torch.sum(D * S, dim=-1) / torch.clamp(var2, min=1e-9)
    t = mu1 - s[..., None] * lie._matvec(R, mu2)
    return R, t, s


def sim3_ransac(p1_c, p2_c, uv1, uv2, valid, cam_params,
                cam_model: int = cameras.PINHOLE, n_hyp: int = 128,
                inlier_px: float = math.sqrt(9.21) * 2.0,
                fix_scale: bool = False, seed: int = 0, hyp_idx=None):
    """Batched Sim3 RANSAC between matched landmark sets.

    p1_c, p2_c (N, 3): the matched landmarks in each keyframe's camera
    frame; uv1, uv2 (N, 2) their keypoints. A hypothesis scores by
    reprojection both ways (Sim3Solver::CheckInliers). `hyp_idx` (n_hyp, 3)
    replaces the sampler's draws (`utils/sampling.py`).

    Returns (R12, t12, s12, inlier_mask, n_inliers)."""
    idx = ransac_indices(valid, n_hyp, 3, seed, hyp_idx)
    Rs, ts, ss = horn_sim3(p1_c[idx], p2_c[idx],
                           torch.ones(idx.shape, device=p1_c.device), fix_scale)

    p2in1 = ss[:, None, None] * torch.einsum("hij,nj->hni", Rs, p2_c) + ts[:, None, :]
    uv1_hat = cameras.project(cam_model, cam_params, p2in1)
    Rinv = Rs.transpose(-1, -2)
    sinv = 1.0 / ss
    tinv = -sinv[:, None] * torch.einsum("hij,hj->hi", Rinv, ts)
    p1in2 = sinv[:, None, None] * torch.einsum("hij,nj->hni", Rinv, p1_c) + tinv[:, None, :]
    uv2_hat = cameras.project(cam_model, cam_params, p1in2)

    e1 = torch.sum((uv1_hat - uv1[None]) ** 2, dim=-1)
    e2 = torch.sum((uv2_hat - uv2[None]) ** 2, dim=-1)
    th2 = inlier_px ** 2
    ok = ((e1 < th2) & (e2 < th2) & (p2in1[..., 2] > 0.05)
          & (p1in2[..., 2] > 0.05) & valid[None, :])
    scores = ok.sum(dim=1, dtype=torch.int32)
    # the first best, as jnp.argmax; gathered on the device (indexing with
    # a 0-d tensor reads it back to the host)
    best = torch.argmax(scores).reshape(1)
    return tuple(x.index_select(0, best)[0] for x in (Rs, ts, ss, ok, scores))


def optimize_sim3(R12, t12, s12, p1_c, p2_c, uv1, uv2, valid, cam_params,
                  cam_model: int = cameras.PINHOLE, n_iters: int = 10,
                  fix_scale: bool = False, chi2_th: float = 10.0,
                  lm_lambda: float = 1e-3):
    """GN refinement of the Sim3 (OptimizeSim3: bidirectional reprojection,
    Huber delta sqrt(10), outliers dropped by the chi2 gate after each
    step). The IRLS weights are constants of each step's Jacobian, as the
    reference's `stop_gradient`.

    Returns (R12, t12, s12, inlier_mask, n_inliers)."""
    delta = math.sqrt(chi2_th)
    dev = p1_c.device
    valid_f = valid.to(torch.float32)
    # dx is a batch (B, 7) of deltas (one, or the Jacobian's seven copies)
    R0, t0, s0 = R12[None], t12[None], s12.reshape(1)

    def apply(dx):
        dR, dt, ds = lie.sim3_exp(dx)
        R2, t2, s2 = lie.sim3_compose(dR, dt, ds, R0, t0, s0)
        if fix_scale:
            s2 = s0.expand_as(s2)
        return lie.normalize_rotation(R2), t2, s2

    def raw_residuals(dx):
        """(B, 7) -> (B, N * 4): both reprojection residuals per point."""
        R2, t2, s2 = apply(dx)
        Ri, ti, si = lie.sim3_inverse(R2, t2, s2)
        p2in1 = s2[:, None, None] * lie._matvec(R2[:, None], p2_c) + t2[:, None]
        p1in2 = si[:, None, None] * lie._matvec(Ri[:, None], p1_c) + ti[:, None]
        uv1_hat = cameras.project(cam_model, cam_params, p2in1)
        uv2_hat = cameras.project(cam_model, cam_params, p1in2)
        return torch.cat([uv1_hat - uv1, uv2_hat - uv2], dim=-1).reshape(dx.shape[0], -1)

    def chi2_of(r):
        r = r.reshape(-1, 4)
        return torch.maximum(torch.sum(r[:, :2] ** 2, -1), torch.sum(r[:, 2:] ** 2, -1))

    eye7 = torch.eye(7, device=dev)
    dx = torch.zeros((1, 7), device=dev)
    inlier = valid_f
    for _ in range(n_iters):
        r, J = lie.value_and_rowwise_jacobian(raw_residuals, dx)
        r, J = r[0].reshape(-1, 4), J[0].reshape(-1, 4, 7)
        sw = torch.sqrt(huber_weight(chi2_of(r), delta) * inlier * valid_f)
        rw = (r * sw[:, None]).reshape(-1)
        J = (J * sw[:, None, None]).reshape(-1, 7)
        H = J.T @ J
        H = H + lm_lambda * torch.diag(torch.diagonal(H)) + 1e-6 * eye7
        dx = dx - torch.linalg.solve_ex(H, J.T @ rw)[0]
        inlier = (chi2_of(raw_residuals(dx)) <= chi2_th).to(torch.float32)
    R2, t2, s2 = apply(dx)
    mask = (inlier > 0) & valid
    return R2[0], t2[0], s2[0], mask, mask.sum(dtype=torch.int32)
