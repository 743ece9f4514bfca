"""Trajectory evaluation: ATE / RPE with SE(3)/Sim(3) alignment, plus
TUM/EuRoC/KITTI trajectory writers (reference: System::SaveTrajectory*
(System.h:158-179) — the output formats the benchmark tooling consumes).

A numpy-only copy of `orbslam3lib_tpu/evaluation.py`, which cannot be
imported without JAX."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity aligning src -> dst, both (N, 3).
    Returns (s, R, t) with dst ~ s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after alignment (the BASELINE.md metric)."""
    s, R, t = umeyama_alignment(est_centers, gt_centers, with_scale)
    aligned = (s * (R @ est_centers.T)).T + t
    return float(np.sqrt(((aligned - gt_centers) ** 2).sum(axis=1).mean()))


def multimap_report(maps_kf, origins, spawn, merge, trajectory, states):
    """chip_smoke.py's phase M numbers (a map lost and merged back on the
    bench orbit: 24 s a turn, radius 0.5 m) from host arrays, for either
    package's run.

    maps_kf: the final current map's (kf_valid, kf_R, kf_t, kf_ts) numpy
    arrays; origins: [(first slot, ts origin)] in slot order (B's slots
    before the merge, A's appended block, B's later keyframes); spawn /
    merge: dicts of the frame and counts at those events; trajectory:
    [(ts, R, t) or None] per frame; states: per-frame state codes (1 = OK)."""
    from .io.synthetic import orbit_pose_at
    v, R, t, kts = maps_kf
    slots = np.arange(len(v))
    origin = np.zeros(len(v))
    for first, org in origins:
        origin[slots >= first] = org
    sel = np.flatnonzero(v)
    est = -np.einsum("kji,kj->ki", R[sel], t[sel])
    gt = orbit_pose_at(kts[sel].astype(np.float64) + origin[sel], period=24.0,
                       radius=0.5)[1]
    out = {"kf_ate_merged_m": ate_rmse(est, gt) if len(sel) >= 3 else None,
           "n_kf_alive_end": int(len(sel))}

    def seg_ate(lo, hi):
        idx = [i for i in range(lo, min(hi, len(trajectory)))
               if states[i] == 1 and trajectory[i] is not None]
        if len(idx) < 3:
            return None
        c = np.stack([-trajectory[i][1].T @ trajectory[i][2] for i in idx])
        g = orbit_pose_at(np.asarray([trajectory[i][0] for i in idx]), period=24.0,
                          radius=0.5)[1]
        return ate_rmse(c, g)

    s_frame = spawn["frame"] if spawn else len(trajectory)
    out["ate_a_m"] = seg_ate(0, s_frame)
    out["ate_b_m"] = seg_ate(s_frame, len(trajectory)) if spawn else None
    return out


def rpe_rmse(est_centers: np.ndarray, gt_centers: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over frame pairs delta apart."""
    de = est_centers[delta:] - est_centers[:-delta]
    dg = gt_centers[delta:] - gt_centers[:-delta]
    return float(np.sqrt(((de - dg) ** 2).sum(axis=1).mean()))


def rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (qx, qy, qz, qw) TUM order."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw, qx = 0.25 * s, (R[2, 1] - R[1, 2]) / s
        qy, qz = (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            qw, qx = (R[2, 1] - R[1, 2]) / s, 0.25 * s
            qy, qz = (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            qw, qx = (R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s
            qy, qz = 0.25 * s, (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            qw, qx = (R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s
            qy, qz = (R[1, 2] + R[2, 1]) / s, 0.25 * s
    return np.array([qx, qy, qz, qw])


def save_trajectory_tum(path: str, timestamps: Sequence[float],
                        poses_cw: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """TUM format: `ts tx ty tz qx qy qz qw` of the world-from-camera pose
    (System::SaveTrajectoryTUM semantics — camera center + orientation)."""
    with open(path, "w") as f:
        for ts, (R, t) in zip(timestamps, poses_cw):
            Rwc = R.T
            c = -Rwc @ t
            q = rotmat_to_quat_np(Rwc)
            f.write(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_trajectory_kitti(path: str,
                          poses_cw: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """KITTI format: rows of the 3x4 world-from-camera matrix."""
    with open(path, "w") as f:
        for R, t in poses_cw:
            Rwc = R.T
            c = -Rwc @ t
            M = np.concatenate([Rwc, c[:, None]], axis=1).reshape(-1)
            f.write(" ".join(f"{v:.7e}" for v in M) + "\n")
