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


def imu_report(trajectory, maps_kf, ts_origin: float, grey_ts, kf_bias=None,
               init_ts=None, speed: float = 0.8, wiggle: float = 0.25) -> dict:
    """chip_smoke.py's phase I numbers (stereo-inertial SLAM down the
    corridor of `io.synthetic.corridor_pose_at`) from host arrays, for
    either package's run. trajectory: [(ts, R, t)] of the tracked frames;
    maps_kf: the final map's (kf_valid, kf_R, kf_t, kf_ts) numpy arrays;
    ts_origin: the map's stamp origin; grey_ts: the stamps of the grey
    frames, which the tracker dead-reckons on the IMU; kf_bias: the map's
    (kf_bg, kf_ba) arrays and init_ts the IMU initialisation's stamp.

    ate_m / kf_ate_m: SE(3)-aligned ATE of the trajectory and of the valid
    keyframes; grey_err_m: the largest error of a grey frame's centre under
    the trajectory's alignment; kf_bias_g / kf_bias_a: the median over the
    keyframes from the initialisation on of their VI-BA biases (the IMU's
    biases are constant: one frame's estimate swings by +-0.1 m/s^2).
    speed / wiggle: the corridor's (`corridor_pose_at`)."""
    from .io.synthetic import corridor_pose_at
    t_traj = np.asarray([f[0] for f in trajectory], np.float64)
    est = np.stack([-np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
                    for _, R, t in trajectory])
    gt = corridor_pose_at(t_traj, speed, wiggle)[1]
    s, R_al, t_al = umeyama_alignment(est, gt)
    err = np.linalg.norm((R_al @ est.T).T + t_al - gt, axis=1)
    grey = np.isin(np.round(t_traj, 6), np.round(np.asarray(grey_ts, np.float64), 6))
    v, R, t, kts = maps_kf
    sel = np.flatnonzero(v)
    est_kf = -np.einsum("kji,kj->ki", R[sel].astype(np.float64), t[sel].astype(np.float64))
    gt_kf = corridor_pose_at(kts[sel].astype(np.float64) + ts_origin, speed, wiggle)[1]
    out = {}
    if kf_bias is not None and init_ts is not None:
        since = sel[kts[sel].astype(np.float64) + ts_origin >= init_ts - 1e-6]
        for name, b in zip(("kf_bias_g", "kf_bias_a"), kf_bias):
            out[name] = np.median(np.asarray(b, np.float64)[since], axis=0).tolist()
        out["kf_bias_n"] = int(len(since))
    return {**out, "ate_m": float(np.sqrt((err ** 2).mean())),
            "kf_ate_m": ate_rmse(est_kf, gt_kf) if len(sel) >= 3 else None,
            "grey_err_m": float(err[grey].max()) if grey.any() else None,
            "grey_frames_tracked": int(grey.sum()),
            "trajectory_frames": int(len(trajectory))}


def imu_mono_report(trajectory, maps_kf, ts_origin: float, init_ts, kf_bias,
                    speed: float, wiggle: float) -> dict:
    """chip_smoke.py's phase J numbers (monocular-inertial SLAM down the
    corridor driven at `speed` with sway `wiggle`) from host arrays, for
    either package's run; the arguments as `imu_report`'s.

    ate_post_init_m: the ATE of the frames tracked from the IMU
    initialisation on, aligned by SE(3) with no scale (after the
    initialisation the map is metric), over those with finite centres
    (`nonfinite_frames` counts the others); sim3_scale: the scale a Sim(3)
    alignment of those frames applies (1 for a metric map); kf_ate_m and
    kf_bias_g / kf_bias_a: `imu_report`'s keyframe ATE (every keyframe is
    in the metric map after the initialisation) and median keyframe biases
    since the initialisation."""
    from .io.synthetic import corridor_pose_at
    out = {"ate_post_init_m": None, "sim3_scale": None, "post_init_frames": 0,
           "nonfinite_frames": 0}
    if init_ts is None:
        return out
    post = [f for f in trajectory if f[0] >= init_ts - 1e-6]
    out["post_init_frames"] = len(post)
    est = np.stack([-np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
                    for _, R, t in post]) if post else np.zeros((0, 3))
    finite = np.isfinite(est).all(axis=1)
    out["nonfinite_frames"] = int((~finite).sum())
    if finite.sum() >= 3:
        t_post = np.asarray([f[0] for f in post], np.float64)[finite]
        est = est[finite]
        gt = corridor_pose_at(t_post, speed, wiggle)[1]
        out["ate_post_init_m"] = ate_rmse(est, gt)
        out["sim3_scale"] = umeyama_alignment(est, gt, with_scale=True)[0]
    fin = [f for f in trajectory
           if np.isfinite(np.asarray(f[1])).all() and np.isfinite(np.asarray(f[2])).all()]
    v, R, t, kts = maps_kf
    v = v & np.isfinite(R).all(axis=(1, 2)) & np.isfinite(t).all(axis=1)
    rep = imu_report(fin, (v, R, t, kts), ts_origin, [], kf_bias, init_ts, speed, wiggle)
    return {**out, **{k: rep[k] for k in ("kf_bias_g", "kf_bias_a", "kf_bias_n", "kf_ate_m")
                      if k in rep}}


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
