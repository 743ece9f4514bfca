"""Recording what the timed path produces on sampled frames, for the
correctness check after the window.

While a sampled frame is tracked, thin wrappers around the program's own
calls keep device copies (no host wait) of: the extractor's features and
the FAST threshold it was given; the stereo depths after the SAD
refinement; every motion-only pose solve's inputs and result, with the chi2
and behind flags of each round's outlier classification; and, with an
IMU, the frame's preintegration with the bias it started from and its
visual-inertial solve's inputs and result. Frames not sampled pay one flag
test per wrapped call.

The keyframe back end's window solves (local BA, and with an IMU the VI
window) are sampled apart, by seeded reservoirs over every call in the
window: a chosen call keeps the map fields the solve reads, its arguments
and the window's result; the others pay one draw.
"""
from __future__ import annotations

import importlib
import inspect
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

FEATURE_FIELDS = ("xy", "level", "angle", "desc", "valid")
PREINT_FIELDS = ("dR", "dV", "dP")
PRE_TENSORS = ("dt", "dR", "dV", "dP", "cov", "cov_bias", "JRg", "JVg", "JVa",
               "JPg", "JPa", "bg", "ba")
MAP_FIELDS = ("kf_valid", "kf_feat_valid", "kf_mp", "kf_xy", "kf_level", "kf_depth",
              "kf_R", "kf_t", "mp_valid", "mp_pos")
STATE_FIELDS = ("R", "t", "v", "bg", "ba")
BACKEND_SOLVES = ("local_ba", "vi_window")


@dataclass
class FrameCapture:
    index: int                      # frame index in the sequence
    threshold: Optional[float] = None
    feats: Optional[dict] = None    # FEATURE_FIELDS -> (2, N, ...) tensors
    stereo: Optional[tuple] = None  # (u_r, depth) of the left eye
    solves: List[dict] = field(default_factory=list)
    preint: Optional[dict] = None   # bg, ba, dR, dV, dP
    inertial: List[dict] = field(default_factory=list)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(y) for y in x)
    return x


def _fields(obj, names) -> dict:
    return {f: _clone(getattr(obj, f)) for f in names}


def _map_copy(m) -> SimpleNamespace:
    """The map fields a window solve reads, copied on the device."""
    return SimpleNamespace(**_fields(m, MAP_FIELDS), max_kf=m.max_kf, max_mp=m.max_mp,
                           n_feat=m.n_feat)


class Recorder:
    """Installs the wrappers on the program's modules (and on a tracker
    instance for the IMU) and keeps the captures of the frames it is told
    to record."""

    def __init__(self, tracker_mod, matching_mod, tracker, seed: int, k_backend: int):
        self.tm, self.mm, self.tracker = tracker_mod, matching_mod, tracker
        self.pm = importlib.import_module(tracker_mod.__package__ + ".pose_opt")
        self.residuals: Optional[list] = None   # a sampled pose solve's evaluations
        self.current: Optional[FrameCapture] = None
        self.frames: List[FrameCapture] = []
        self.backend: Dict[str, Reservoir] = {
            kind: Reservoir(np.random.default_rng([int(seed) % (2 ** 63), i + 1]), k_backend)
            for i, kind in enumerate(BACKEND_SOLVES)}
        self._saved: List[tuple] = []

    # -- the wrappers ------------------------------------------------------
    def _wrap_module(self, mod, name: str, make):
        orig = getattr(mod, name)
        self._saved.append((mod, name, orig))
        setattr(mod, name, make(orig))

    def install(self) -> "Recorder":
        rec = self

        def extract(orig):
            def wrapped(img, threshold, *a, **k):
                out = orig(img, threshold, *a, **k)
                cur = rec.current
                if cur is not None:
                    feats = out[0] if isinstance(out, tuple) else out
                    cur.threshold = float(threshold)
                    cur.feats = {f: _clone(getattr(feats, f)) for f in FEATURE_FIELDS}
                return out
            return wrapped

        def stereo(orig):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                if rec.current is not None:
                    rec.current.stereo = tuple(_clone(x) for x in out)
                return out
            return wrapped

        iters_default = inspect.signature(
            self.pm.pose_optimization).parameters["iters_per_round"].default

        def solve(orig):
            def wrapped(R0, t0, obs, cam_params, *a, **k):
                cur = rec.current
                if cur is None:
                    return orig(R0, t0, obs, cam_params, *a, **k)
                rec.residuals = []
                try:
                    out = orig(R0, t0, obs, cam_params, *a, **k)
                finally:
                    calls, rec.residuals = rec.residuals, None
                # every round ends with one more evaluation, its classification
                per = int(k.get("iters_per_round", iters_default)) + 1
                cur.solves.append({
                    "R0": _clone(R0), "t0": _clone(t0),
                    "obs": {f: _clone(getattr(obs, f)) for f in obs._fields},
                    "cam_params": _clone(cam_params), "args": a, "kwargs": dict(k),
                    "R": _clone(out[0]), "t": _clone(out[1]),
                    "classified": calls[per - 1::per]})
                return out
            return wrapped

        def residuals(orig):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                if rec.residuals is not None:
                    rec.residuals.append((_clone(out[2]), _clone(out[3])))
                return out
            return wrapped

        def local_ba(orig):
            def wrapped(m, window_ids, fixed_mask, *a, **k):
                slot = rec.backend["local_ba"].offer(None)
                if slot is None:
                    return orig(m, window_ids, fixed_mask, *a, **k)
                cap = {"map": _map_copy(m), "ids": _clone(window_ids),
                       "fixed": _clone(fixed_mask), "args": _clone(a), "kwargs": dict(k)}
                out = orig(m, window_ids, fixed_mask, *a, **k)
                ids = torch.clamp(window_ids, 0, out.max_kf - 1).long()
                cap["R"], cap["t"] = out.kf_R[ids].clone(), out.kf_t[ids].clone()
                rec.backend["local_ba"].chosen[slot] = cap
                return out
            return wrapped

        def vi_window(orig):
            def wrapped(m, window_ids, fixed_mask, pres, *a, **k):
                slot = rec.backend["vi_window"].offer(None)
                if slot is None:
                    return orig(m, window_ids, fixed_mask, pres, *a, **k)
                cap = {"map": _map_copy(m), "ids": _clone(window_ids),
                       "fixed": _clone(fixed_mask), "pres": _fields(pres, PRE_TENSORS),
                       "args": _clone(a), "kwargs": {n: _clone(v) for n, v in k.items()}}
                out = orig(m, window_ids, fixed_mask, pres, *a, **k)
                cap["out"] = dict(zip(STATE_FIELDS, (_clone(x) for x in out)))
                rec.backend["vi_window"].chosen[slot] = cap
                return out
            return wrapped

        self._wrap_module(self.tm, "extract_orb_stereo", extract)
        self._wrap_module(self.mm, "match_rectified_stereo", stereo)
        self._wrap_module(self.mm, "refine_stereo_sad", stereo)
        self._wrap_module(self.tm, "pose_optimization", solve)
        self._wrap_module(self.pm, "_residuals_jacobians", residuals)
        self._wrap_module(self.tm, "_local_ba", local_ba)
        if self.tracker.cfg.use_imu:
            tr = self.tracker
            self._wrap_module(self.tm, "local_inertial_ba", vi_window)
            feed = tr.feed_imu

            def feed_imu(gyro, acc, dts):
                cur = rec.current
                bias = tuple(_clone(b) for b in tr.imu_bias) if cur is not None else None
                fresh = tr._pre_frame is None
                feed(gyro, acc, dts)
                if cur is not None and fresh and tr._pre_frame is not None:
                    cur.preint = {"bg": bias[0], "ba": bias[1],
                                  **{f: _clone(getattr(tr._pre_frame, f))
                                     for f in PREINT_FIELDS}}
            self._saved.append((tr, "feed_imu", None))
            tr.feed_imu = feed_imu
            refine = tr._inertial_refine

            def inertial_refine(cur, obs):
                c = rec.current
                if c is None:
                    return refine(cur, obs)
                # the inputs are copied before the solve: its graph writes
                # the previous solve's state, which is this one's prior
                prior = tr._inertial_prior
                cap = {"cur": _fields(cur, STATE_FIELDS),
                       "obs": {f: _clone(getattr(obs, f)) for f in obs._fields},
                       "other": _fields(prior[0] if prior is not None else tr.anchor_state,
                                        STATE_FIELDS),
                       "prior_H": _clone(prior[1]) if prior is not None else None,
                       "pre": _fields(tr._pre_frame, PRE_TENSORS),
                       "cam_params": _clone(tr.cam_params), "tbc": _clone(tuple(tr._tbc)),
                       "cam_model": int(tr.cfg.camera.model_id), "bf": float(tr.cfg.bf)}
                out = refine(cur, obs)
                cap["out"] = _fields(out[0], STATE_FIELDS)
                c.inertial.append(cap)
                return out
            self._saved.append((tr, "_inertial_refine", None))
            tr._inertial_refine = inertial_refine
        return self

    def uninstall(self) -> None:
        for obj, name, orig in reversed(self._saved):
            if orig is None:
                delattr(obj, name)      # the instance attribute goes; the method stays
            else:
                setattr(obj, name, orig)
        self._saved.clear()

    # -- per frame ---------------------------------------------------------
    def begin(self, index: int) -> None:
        self.current = FrameCapture(index)

    def end(self) -> None:
        if self.current is not None:
            self.frames.append(self.current)
        self.current = None


class Reservoir:
    """A seeded reservoir sampler over a stream of unknown length: `offer(x)`
    returns the slot of `chosen` that x takes, or None where it does not
    enter the sample; `chosen` holds the sample at the end, k items drawn
    uniformly from the stream by `rng` (a caller may fill the slot later)."""

    def __init__(self, rng: np.random.Generator, k: int):
        self.rng, self.k = rng, k
        self.chosen: List[Any] = []
        self.n = 0

    def offer(self, item) -> Optional[int]:
        self.n += 1
        if len(self.chosen) < self.k:
            self.chosen.append(item)
            return len(self.chosen) - 1
        j = int(self.rng.integers(0, self.n))
        if j < self.k:
            self.chosen[j] = item
            return j
        return None
