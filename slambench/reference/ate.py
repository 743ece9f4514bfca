"""Absolute trajectory error against the generated poses (numpy, float64):
the RMSE of camera centres after the rigid (SE(3)) alignment of Horn /
Umeyama that best maps the estimate onto the truth."""
from __future__ import annotations

import numpy as np


def align_se3(est: np.ndarray, gt: np.ndarray):
    """(R, t) minimising sum |R est_i + t - gt_i|^2 over rotations."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    H = (est - mu_e).T @ (gt - mu_g)
    U, _, Vt = np.linalg.svd(H)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    return R, mu_g - R @ mu_e


def ate_rmse(est, gt) -> float:
    """RMSE (m) of (N, 3) estimated centres against (N, 3) true centres after
    the SE(3) alignment; inf when fewer than three are given or any is not
    finite."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if len(est) < 3 or not np.isfinite(est).all():
        return float("inf")
    R, t = align_se3(est, gt)
    return float(np.sqrt(np.mean(np.sum((est @ R.T + t - gt) ** 2, axis=1))))


def centres(R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of (N, 3, 3) camera-from-world rotations and
    (N, 3) translations."""
    return -np.einsum("nji,nj->ni", np.asarray(R_cw, np.float64), np.asarray(t_cw, np.float64))
