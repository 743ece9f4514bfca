"""Pose-graph (essential-graph) optimisation over Sim(3), SE(3) or 4 DoF
(port of `orbslam3lib_tpu/mapping/pose_graph.py`).

The reference's OptimizeEssentialGraph (Optimizer.cc:1511, 7 DoF over
relative Sim3 edges of the spanning tree, strong covisibility and loops) and
OptimizeEssentialGraph4DoF (Optimizer.cc:5338, yaw and translation) as a
dense Gauss-Newton: per edge, r = log(S_meas S_j S_i^-1) and its two 7x7
Jacobian blocks by forward mode over all edges at once
(`lie.value_and_rowwise_jacobian`; the reference vmaps `jax.jacfwd`), scattered
(`index_add_`) into a dense (7K, 7K) normal matrix solved by LU (`solve_ex`: its status stays on the device). Fixed and invalid
keyframes and masked DoF get identity rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import to_device
from ..utils import lie

# parameter mask over [rho(3), phi(3), sigma]: one row per mode
_DOF_MASKS = {
    "sim3": (1, 1, 1, 1, 1, 1, 1),
    "se3": (1, 1, 1, 1, 1, 1, 0),
    # translation + rotation about gravity (+y here): phi_x = phi_z = 0
    "4dof": (1, 1, 1, 0, 1, 0, 0),
}


def _compose_delta(dx, R, t, s):
    dR, dt, ds = lie.sim3_exp(dx)
    R2, t2, s2 = lie.sim3_compose(dR, dt, ds, R, t, s)
    return lie.normalize_rotation(R2), t2, s2


def optimize_pose_graph(kf_R, kf_t, kf_s, kf_valid, kf_fixed,
                        e_i, e_j, e_R, e_t, e_s, e_valid,
                        mode: str = "sim3", n_iters: int = 20,
                        lm_lambda: float = 1e-4):
    """Optimise world->cam Sim3 poses S_k = (R, t, s) against relative
    constraints S_ij (measuring S_j S_i^-1). Returns (kf_R, kf_t, kf_s)."""
    K = kf_R.shape[0]
    dev = kf_R.device
    dof = to_device(np.asarray(_DOF_MASKS[mode], np.float32), dev)
    free = (kf_valid & ~kf_fixed).to(torch.float32)
    e_i, e_j = e_i.long(), e_j.long()
    ev = e_valid.to(torch.float32)

    def edge_residual(dxi, dxj, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        Ri2, ti2, si2 = _compose_delta(dxi * dof, Ri, ti, si)
        Rj2, tj2, sj2 = _compose_delta(dxj * dof, Rj, tj, sj)
        # S_err = S_meas_ij * S_j * S_i^-1 (identity when satisfied)
        Rw, tw, sw = lie.sim3_compose(Rj2, tj2, sj2, *lie.sim3_inverse(Ri2, ti2, si2))
        Re, te, se = lie.sim3_compose(Rm, tm, sm, *lie.sim3_inverse(Rw, tw, sw))
        return lie.sim3_log(Re, te, se)

    mask = free[:, None] * dof[None, :]                        # (K, 7)
    dmask = mask.reshape(-1)
    eye = torch.eye(K * 7, device=dev)
    z = torch.zeros((e_i.shape[0], 14), device=dev)
    kfR, kft, kfs = kf_R, kf_t, kf_s
    for _ in range(n_iters):
        args = (kfR[e_i], kft[e_i], kfs[e_i], kfR[e_j], kft[e_j], kfs[e_j],
                e_R, e_t, e_s)
        # both endpoints' 7 + 7 columns in one forward-mode product
        r, J = lie.value_and_rowwise_jacobian(
            lambda d, *a: edge_residual(d[:, :7], d[:, 7:], *a), z, *args)
        Ji, Jj = J[..., :7], J[..., 7:]
        r, Ji, Jj = r * ev[:, None], Ji * ev[:, None, None], Jj * ev[:, None, None]
        Hii = torch.einsum("eri,erj->eij", Ji, Ji)
        Hjj = torch.einsum("eri,erj->eij", Jj, Jj)
        Hij = torch.einsum("eri,erj->eij", Ji, Jj)
        H = torch.zeros((K * K, 7, 7), device=dev)
        H.index_add_(0, e_i * K + e_i, Hii)
        H.index_add_(0, e_j * K + e_j, Hjj)
        H.index_add_(0, e_i * K + e_j, Hij)
        H.index_add_(0, e_j * K + e_i, Hij.transpose(-1, -2))
        H = H.reshape(K, K, 7, 7).transpose(1, 2)
        b = torch.zeros((K, 7), device=dev)
        b.index_add_(0, e_i, torch.einsum("eri,er->ei", Ji, r))
        b.index_add_(0, e_j, torch.einsum("eri,er->ei", Jj, r))

        # gauge: rows/cols of fixed or invalid keyframes and masked DoF
        # become identity
        H = H * mask[:, :, None, None] * mask[None, None, :, :]
        Hf = H.reshape(K * 7, K * 7)
        Hf = (Hf + torch.diag(1.0 - dmask) + lm_lambda * torch.diag(torch.diagonal(Hf))
              + 1e-8 * eye)
        dx = -torch.linalg.solve_ex(Hf, (b * mask).reshape(-1))[0].reshape(K, 7)
        kfR, kft, kfs = _compose_delta(dx * mask, kfR, kft, kfs)
    return kfR, kft, kfs


def relative_sim3(Ri, ti, si, Rj, tj, sj):
    """Measurement S_ij = S_i S_j^-1 from two absolute poses (the edge
    constraint the reference builds from the pre-correction poses)."""
    return lie.sim3_compose(Ri, ti, si, *lie.sim3_inverse(Rj, tj, sj))
