"""The comparison that decides `correct`: what the timed path produced,
against the plain reference under `reference/`, number by number, each
beside its limit (`limits/<workload>.json`).

- `frontend_mismatch`: on the sampled window frames, the keypoint slots of
  both eyes whose position, level, angle, descriptor or validity differ
  from the reference extractor's on the same raw frame and FAST threshold
  (the reference rectifies a raw rig itself), plus the left-eye slots whose
  stereo depth or right coordinate differ. Exact.
- `pose_gap`: every motion-only pose solve of the sampled frames, re-solved
  by the reference in float64 from the inputs the program gave its solver:
  the largest rotation (rad) or translation (m) between the two results.
  An outlier decision within `TIE_BAND` of its chi2 gate is a tie, which the
  reference takes as the program made it (recorded in the window); it makes
  every other decision itself.
- `preint_gap` (with an IMU): each sampled frame's preintegration from the
  raw samples and the bias it started from, in float64: the largest
  rotation (rad), velocity (m/s) or position (m) gap.
- `inertial_gap` (with an IMU): each sampled frame's visual-inertial solve
  re-solved in float64 from the inputs the program gave it (the tracked
  state, its observations, the anchor or the previous solve's state and
  marginal prior, the frame's preintegration): the largest rotation (rad),
  translation (m), velocity (m/s) or bias gap of the frame's state.
- `local_ba_gap`: the local BAs drawn from the window's (seeded), each
  re-solved in float64 from the map the program gave it: the largest
  rotation (rad) or translation (m) gap of the window's free keyframes.
- `vi_window_gap` (with an IMU): the VI windows drawn likewise, re-solved in
  float64: the largest pose, velocity or bias gap of the window's
  keyframes.

Reported beside them and not judged (the control moves them too little
for a limit to separate it from sound runs):
- `ate_m`: the window's trajectory against the generated poses (RMSE after
  an SE(3) alignment).
- `kf_ate_m`: the keyframes made in the window, as the map holds them at
  the window's end, against the generated poses at their stamps.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from types import SimpleNamespace

from ..reference import ate as ref_ate
from ..reference import backend as ref_backend
from ..reference import inertial_opt as ref_inertial
from ..reference import cameras as ref_cameras
from ..reference import extractor as ref_extractor
from ..reference import matching as ref_matching
from ..reference import pose_opt as ref_pose
from ..reference import rectify as ref_rectify
from ..reference.imu import Pre
from ..reference.preint import preintegrate
from .capture import FEATURE_FIELDS, FrameCapture
from .world import pose_at


class Precision:
    """How a reference computation runs: its dtype, whether float32 matrix
    products may use TF32, and the dtype its floating inputs are stored in
    first (None: as given; a control's bfloat16)."""

    def __init__(self, dtype=torch.float32, tf32: bool = False, storage=None):
        self.dtype, self.tf32, self.storage = dtype, tf32, storage

    def __enter__(self):
        self._saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        return self

    def __exit__(self, *a):
        torch.backends.cuda.matmul.allow_tf32 = self._saved


class FrontEnd:
    """The reference front end of one configuration: rectification (a raw
    rig), extraction, rectified stereo matching and the SAD refinement."""

    def __init__(self, config: dict, device: torch.device):
        slam = config["slam"]
        cam, st = slam["camera"], slam.get("stereo", {})
        self.device = device
        self.max_kp = int(slam["orb"]["max_kp"])
        self.n_levels = int(slam["orb"]["n_levels"])
        self.min_z = float(st.get("min_z", 0.3))
        self.sad = bool(st.get("sad_refine", True))
        self.remap = None
        fx, baseline = float(cam["fx"]), float(st["baseline"])
        dist = tuple(float(x) for x in cam.get("dist", (0.0,) * 5))
        if st.get("rectify", False):
            params = np.asarray([cam["fx"], cam["fy"], cam["cx"], cam["cy"], *dist], np.float32)
            model = ref_cameras.PINHOLE_RADTAN if any(dist) else ref_cameras.PINHOLE
            rr = ref_rectify.stereo_rectify(
                params, params, model, model, np.eye(3, dtype=np.float32),
                np.asarray([baseline, 0.0, 0.0], np.float32),
                int(cam["width"]), int(cam["height"]))
            self.remap = ref_rectify.TwoPassRemap(ref_rectify.twopass_maps(rr.maps), device)
            fx, baseline = float(rr.new_params[0]), float(rr.baseline)
        self.bf = fx * baseline

    def __call__(self, pair: np.ndarray, threshold: float):
        img = torch.as_tensor(pair, device=self.device)
        if self.remap is not None:
            img = self.remap(img)
        feats, canvas = ref_extractor.extract_orb_stereo(
            img, float(np.float32(threshold)), max_kp=self.max_kp, n_levels=self.n_levels,
            return_canvas=True)
        u_r, depth = ref_matching.match_rectified_stereo(
            feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
            feats.xy[1], feats.level[1], feats.desc[1], feats.valid[1],
            self.bf, self.min_z, n_levels=self.n_levels)
        if self.sad:
            u_r, depth = ref_matching.refine_stereo_sad(
                canvas[0], canvas[1], feats.xy[0], feats.level[0], feats.valid[0], u_r,
                depth, bf=self.bf, min_z=self.min_z, n_levels=self.n_levels)
        return feats, (u_r, depth)


def _count_diff(feats_a: dict, stereo_a, feats_b: dict, stereo_b) -> int:
    """Keypoint slots (both eyes) where any feature field differs, plus
    left-eye slots where the right coordinate or the depth differs."""
    valid = feats_a["valid"]
    diff = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    for f in FEATURE_FIELDS:
        ne = feats_a[f] != feats_b[f].to(valid.device)
        diff |= ne.reshape(ne.shape[0], ne.shape[1], -1).any(-1)
    bad = int(diff.sum())
    for a, b in zip(stereo_a, stereo_b):
        bad += int((a != b.to(a.device)).sum())
    return bad


def _as_dict(feats) -> dict:
    return {f: getattr(feats, f) for f in FEATURE_FIELDS}


def frontend_mismatch(caps: List[FrameCapture], frame_of, fe: FrontEnd) -> int:
    """Slots that differ between the captured front end and the reference's
    on the same frames and thresholds (see the module's note); a sampled
    frame whose outputs were not captured counts every slot."""
    bad = 0
    with Precision():
        for cap in caps:
            if cap.feats is None or cap.stereo is None or cap.threshold is None:
                bad += 3 * fe.max_kp
                continue
            feats, stereo = fe(frame_of(cap.index), cap.threshold)
            bad += _count_diff(cap.feats, cap.stereo, _as_dict(feats), stereo)
    return bad


def frontend_control(caps: List[FrameCapture], frame_of, fe: FrontEnd,
                     control: Precision) -> int:
    """The control's reading: the reference front end run at `control`
    (TF32 products: the pyramid's resampling is two matrix products) in
    the program's place, against the reference at full float32."""
    bad = 0
    for cap in caps:
        if cap.threshold is None:
            continue
        with Precision():
            feats, stereo = fe(frame_of(cap.index), cap.threshold)
        with control:
            feats_c, stereo_c = fe(frame_of(cap.index), cap.threshold)
        bad += _count_diff(_as_dict(feats_c), stereo_c, _as_dict(feats), stereo)
    return bad


def _rot_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> float:
    """The angle between two rotations from the skew part of Ra^T Rb (an
    arccos of the trace loses small angles to rounding)."""
    M = Ra.T @ Rb
    v = torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) * 0.5
    return float(torch.asin(torch.clamp(torch.linalg.norm(v), max=1.0)))


# A pose solve's outlier classification whose chi2 lies within this share of
# its gate is a tie: float32 against float64 rounding alone puts it on either
# side, and the two solves then go on from inlier sets one observation apart
# (a gap of up to ~1e-3 on a sound program). The float64 reference takes
# such a decision as the solve it is compared with made it, and makes every
# other decision itself.
TIE_BAND = 1e-3


def following(classified: list, band: float = TIE_BAND):
    """A `classify` for the reference's pose solve that takes the decisions
    within `band` of the gate from `classified`, the (chi2, behind) of each
    round's classification of the solve compared with."""
    def classify(k, chi2, behind, chi2_th, own):
        if k >= len(classified):
            return own
        c, b = (x.to(chi2.device) for x in classified[k])
        theirs = (c.to(chi2.dtype) <= chi2_th) & ~b
        tie = (chi2 - chi2_th).abs() <= band * chi2_th
        return torch.where(tie, theirs, own)
    return classify


def recording(classified: list):
    """A `classify` that keeps the solve's own decisions and records them."""
    def classify(k, chi2, behind, chi2_th, own):
        classified.append((chi2, behind))
        return own
    return classify


def resolve(sol: dict, precision: Precision, device, classify=None) -> tuple:
    """One captured pose solve re-run by the reference."""
    f = dict(dtype=precision.dtype, device=device)
    obs = {k: v.to(device=device, dtype=precision.dtype if v.is_floating_point() else v.dtype)
           for k, v in sol["obs"].items()}
    with precision:
        R, t, _, _ = ref_pose.pose_optimization(
            sol["R0"].to(**f), sol["t0"].to(**f), ref_pose.PoseObs(**obs),
            sol["cam_params"].to(**f), *sol["args"], **sol["kwargs"], classify=classify)
    return R, t


def pose_gap(caps: List[FrameCapture], precision: Precision = Precision(torch.float64),
             device="cpu", against_program: bool = True, band: float = TIE_BAND) -> float:
    """The largest gap over the sampled frames' pose solves between the
    program's result (or, with `against_program` False, the reference run at
    `precision`) and the float64 reference, which takes the ties of the
    solve compared with (`TIE_BAND`). No solve captured: inf."""
    worst, n = 0.0, 0
    ref64 = Precision(torch.float64)
    for cap in caps:
        for sol in cap.solves:
            if against_program:
                decided = sol["classified"]
                R, t = sol["R"].to("cpu", torch.float64), sol["t"].to("cpu", torch.float64)
            else:
                decided = []
                R, t = (x.to("cpu", torch.float64) for x in
                        resolve(sol, precision, device, recording(decided)))
            R_ref, t_ref = resolve(sol, ref64, "cpu", following(decided, band))
            worst = max(worst, _rot_angle(R, R_ref), float(torch.linalg.norm(t - t_ref)))
            n += 1
    return worst if n else math.inf


def preint_gap(caps: List[FrameCapture], imu_of, precision: Precision | None = None,
               device="cpu") -> float:
    """The largest gap over the sampled frames between the program's
    preintegration (or the reference at `precision`) and the float64
    reference from the raw samples. None captured: inf."""
    worst, n = 0.0, 0
    for cap in caps:
        p = cap.preint
        samples = imu_of(cap.index)
        if p is None or samples is None:
            continue
        bg, ba = (p[k].double().cpu().numpy() for k in ("bg", "ba"))
        dR, dV, dP = preintegrate(*samples, bg, ba)
        if precision is None:
            got = [p[k].to("cpu", torch.float64) for k in ("dR", "dV", "dP")]
        else:
            with precision:
                got = [x.to("cpu", torch.float64) for x in
                       preintegrate(*samples, bg, ba, dtype=precision.dtype, device=device)]
        worst = max(worst, _rot_angle(got[0], dR), float(torch.linalg.norm(got[1] - dV)),
                    float(torch.linalg.norm(got[2] - dP)))
        n += 1
    return worst if n else math.inf


def _to(x, precision: Precision, device):
    x = x.to(device)
    if not x.is_floating_point():
        return x
    if precision.storage is not None:
        x = x.to(precision.storage)
    return x.to(precision.dtype)


def _state_gap(a, b) -> float:
    """The largest rotation (rad), translation, velocity or bias gap between
    two (R, t, v, bg, ba) states (or batches of them), in float64."""
    a = [x.to("cpu", torch.float64) for x in a]
    b = [x.to("cpu", torch.float64) for x in b]
    gaps = [float(torch.linalg.norm(x - y, dim=-1).max()) for x, y in zip(a[1:], b[1:])]
    return max([_rot_angle_max(a[0], b[0])] + gaps)


def _rot_angle_max(Ra: torch.Tensor, Rb: torch.Tensor) -> float:
    Ra, Rb = Ra.reshape(-1, 3, 3), Rb.reshape(-1, 3, 3)
    return max(_rot_angle(x, y) for x, y in zip(Ra, Rb))


def _inertial_resolve(s: dict, precision: Precision, device) -> tuple:
    """One captured visual-inertial frame solve re-run by the reference."""
    f = lambda x: _to(x, precision, device)  # noqa: E731
    cur = ref_inertial.State(**{k: f(v) for k, v in s["cur"].items()})
    other = ref_inertial.State(**{k: f(v) for k, v in s["other"].items()})
    pre = Pre(**{k: f(v) for k, v in s["pre"].items()})
    obs = ref_pose.PoseObs(**{k: f(v) for k, v in s["obs"].items()})
    R_bc, t_bc = (f(x) for x in s["tbc"])
    kw = dict(cam_params=f(s["cam_params"]), cam_model=s["cam_model"], bf=s["bf"],
              R_bc=R_bc, t_bc=t_bc)
    with precision:
        if s["prior_H"] is None:
            st = ref_inertial.pose_inertial_optimization(cur, other, pre, obs, **kw)
        else:
            st = ref_inertial.pose_inertial_optimization_last_frame(
                cur, other, f(s["prior_H"]), pre, obs, **kw)
    return tuple(st)


def inertial_gap(caps: List[FrameCapture], precision: Precision | None = None,
                 device="cpu") -> float:
    """The largest gap over the sampled frames' visual-inertial solves
    between the program's state (or the reference at `precision`) and the
    float64 reference. None captured: inf."""
    worst, n = 0.0, 0
    for cap in caps:
        for s in cap.inertial:
            ref = _inertial_resolve(s, Precision(torch.float64), device)
            got = tuple(s["out"][k] for k in ref_inertial.State._fields) if precision is None \
                else _inertial_resolve(s, precision, device)
            worst = max(worst, _state_gap(got, ref))
            n += 1
    return worst if n else math.inf


def _map_as(m: SimpleNamespace, precision: Precision, device) -> SimpleNamespace:
    return SimpleNamespace(**{k: _to(v, precision, device) if isinstance(v, torch.Tensor)
                              else v for k, v in vars(m).items()})


def _local_ba_resolve(s: dict, precision: Precision, device):
    f = lambda x: _to(x, precision, device)  # noqa: E731
    cam_params, bf = s["args"][:2]
    kw = s["kwargs"]
    with precision:
        R, t, free = ref_backend.window_ba(
            _map_as(s["map"], precision, device), f(s["ids"]), f(s["fixed"]), f(cam_params),
            float(bf), kw["cam_model"], kw["n_ba_points"], kw["n_iters"])
    return R, t, free


def _vi_window_resolve(s: dict, precision: Precision, device):
    f = lambda x: _to(x, precision, device)  # noqa: E731
    (pre_valid, bg0, ba0, cam_params, bf) = s["args"][:5]
    kw = s["kwargs"]
    with precision:
        out, valid, free = ref_backend.vi_window(
            _map_as(s["map"], precision, device), f(s["ids"]), f(s["fixed"]),
            Pre(**{k: f(v) for k, v in s["pres"].items()}), f(pre_valid), f(bg0), f(ba0),
            f(cam_params), float(bf), kw["cam_model"], kw["n_iters"], kw["n_levels"],
            f(kw["R_bc"]), f(kw["t_bc"]), f(kw["v_init"]), f(kw["v_init_valid"]),
            bool(kw["per_kf_bias"]))
    return out, valid, free


def local_ba_gap(solves: list, precision: Precision | None = None, device="cpu") -> float:
    """The largest gap over the drawn local BAs' free keyframe poses between
    the program's (or the reference at `precision`) and the float64
    reference's. None drawn: inf."""
    worst, n = 0.0, 0
    for s in solves:
        R_ref, t_ref, free = _local_ba_resolve(s, Precision(torch.float64), device)
        if precision is None:
            R, t = s["R"], s["t"]
        else:
            R, t, _ = _local_ba_resolve(s, precision, device)
        free = free.cpu()
        if free.any():
            worst = max(worst, _state_gap((R.cpu()[free], t.cpu()[free]),
                                          (R_ref.cpu()[free], t_ref.cpu()[free])))
        n += 1
    return worst if n else math.inf


def vi_window_gap(solves: list, precision: Precision | None = None, device="cpu") -> float:
    """The largest gap over the drawn VI windows: poses of the free
    keyframes, velocities and biases of the valid ones. None drawn: inf."""
    worst, n = 0.0, 0
    for s in solves:
        ref, valid, free = _vi_window_resolve(s, Precision(torch.float64), device)
        if precision is None:
            o = s["out"]
            got = (o["R"], o["t"], o["v"], o["bg"].expand_as(o["v"]), o["ba"].expand_as(o["v"]))
        else:
            got, _, _ = _vi_window_resolve(s, precision, device)
        valid, free = valid.cpu(), free.cpu()
        got = [x.cpu() for x in got]
        ref = [x.cpu() for x in ref]
        if free.any():
            worst = max(worst, _state_gap((got[0][free], got[1][free]),
                                          (ref[0][free], ref[1][free])))
        if valid.any():
            worst = max(worst, max(float(torch.linalg.norm(
                (g[valid].double() - r[valid].double()), dim=-1).max()) for g, r in
                zip(got[2:], ref[2:])))
        n += 1
    return worst if n else math.inf


def trajectory_ate(entries, traj: dict) -> float:
    """`entries`: (ts, R_cw, t_cw) of the window's frames."""
    if len(entries) < 3:
        return math.inf
    ts = np.asarray([e[0] for e in entries], np.float64)
    est = ref_ate.centres(np.stack([e[1] for e in entries]), np.stack([e[2] for e in entries]))
    return ref_ate.ate_rmse(est, pose_at(traj, ts)[1])


def keyframe_ate(kf_valid, kf_R, kf_t, kf_ts, ts_origin: float, t_first: float,
                 traj: dict) -> float:
    """The map's valid keyframes stamped at or after `t_first` (the
    window's), after the back end's last pass over them."""
    ts = np.asarray(kf_ts, np.float64) + ts_origin
    ok = np.asarray(kf_valid, bool) & (ts >= t_first)
    if ok.sum() < 3:
        return math.inf
    est = ref_ate.centres(np.asarray(kf_R)[ok], np.asarray(kf_t)[ok])
    ts = ts[ok]
    return ref_ate.ate_rmse(est, pose_at(traj, ts)[1])


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit, and every limited number there."""
    return all(k in numbers and numbers[k] <= v for k, v in limits.items())


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {numbers.get(k, float('nan'))!r} limit {limits[k]!r}" for k in limits]
