"""ORB extraction: pyramid -> FAST+NMS (kernel 1) -> per-tile top-K ->
global top-K -> orientation -> BRIEF (port of `orbslam3lib_tpu/ops/extractor.py`).

The two eyes of a stereo pair are a batch dimension all the way through, and
kernel 1 runs once per frame, over every pyramid level of both eyes. Output is the same
fixed-capacity masked `Features` record as the reference, field for field
and dtype for dtype.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from . import fast, pyramid
from .cuda_fast import fast_scores_nms_levels
from .orient_brief import RAW_RADIUS, orient_and_brief

# Reference tile geometry: 128 wide x 80 high, top-16 per tile
TILE_H, TILE_W, TILE_K = 80, 128, 16
DETECT_MARGIN = RAW_RADIUS + 2  # all 45x45 raw-patch gathers stay in bounds
MAX_KP_DEFAULT = 1024


@dataclass
class Features:
    """Fixed-capacity keypoint set; arrays carry a leading eye dimension when
    they come from `extract_orb_stereo`."""
    xy: torch.Tensor       # (..., N, 2) float32, level-0 pixel coords (x, y)
    level: torch.Tensor    # (..., N) int32 pyramid level (-1 = invalid)
    score: torch.Tensor    # (..., N) float32 FAST score
    angle: torch.Tensor    # (..., N) float32 radians
    desc: torch.Tensor     # (..., N, 256) int8 0/1 bits
    valid: torch.Tensor    # (..., N) bool

    @property
    def n_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32), dim=-1)


def _canvas(levels: List[torch.Tensor], h0: int, w0: int) -> torch.Tensor:
    """Stack the levels of (..., H, W) images into one zero-padded
    (..., L, H0, W0) canvas, indexed by (level, y, x)."""
    return torch.stack([F.pad(l, (0, w0 - l.shape[-1], 0, h0 - l.shape[-2]))
                        for l in levels], dim=-3)


def extract_orb_stereo(img_pair: torch.Tensor, threshold: float,
                       max_kp: int = MAX_KP_DEFAULT,
                       n_levels: int = pyramid.N_LEVELS,
                       return_canvas: bool = False):
    """Extract ORB features from a batch of grayscale images.

    img_pair: (B, H, W) uint8/float32 (B = 2 for a stereo pair).
    threshold: FAST score threshold (host-controlled, ThresholdController),
    or a (B,) tensor of one threshold per image (the sharded front end's
    frames, each with its own).
    Returns Features with a leading dim B; with `return_canvas` also the
    (B, L, H, W) zero-padded pyramid canvases (for the SAD stereo refinement).
    """
    nb, h0, w0 = img_pair.shape
    dev = img_pair.device
    levels = pyramid.build_pyramid(img_pair, n_levels)
    scales = pyramid.scale_factors_on(n_levels, dev)

    # kernel 1 on CUDA tensors (one launch), its plain version on the CPU;
    # then per level the per-tile top-K candidates (score, y, x), (B, T*K)
    scores = fast_scores_nms_levels(levels, DETECT_MARGIN)
    cand_s, cand_y, cand_x, cand_l = [], [], [], []
    for lvl, score in enumerate(scores):
        s, y, x = fast.tile_topk(score, TILE_H, TILE_W, TILE_K)
        cand_s.append(s)
        cand_y.append(y)
        cand_x.append(x)
        cand_l.append(torch.full_like(y, lvl))
    s = torch.cat(cand_s, dim=1)
    y = torch.cat(cand_y, dim=1)
    x = torch.cat(cand_x, dim=1)
    l = torch.cat(cand_l, dim=1)

    if torch.is_tensor(threshold) and threshold.dim() == 1:
        threshold = threshold[:, None]
    valid = s > threshold
    s_masked = torch.where(valid, s, torch.zeros_like(s))
    k = min(max_kp, s.shape[1])
    top_s, top_i = fast.topk_stable(s_masked, k)
    if k < max_kp:  # pad up to capacity
        top_s = F.pad(top_s, (0, max_kp - k))
        top_i = F.pad(top_i, (0, max_kp - k))
    kp_y = torch.gather(y, 1, top_i)
    kp_x = torch.gather(x, 1, top_i)
    kp_l = torch.gather(l, 1, top_i)
    kp_valid = top_s > threshold

    canvas = _canvas(levels, h0, w0)                       # (B, L, H, W)
    angle, desc = zip(*[orient_and_brief(canvas[b], kp_l[b], kp_y[b], kp_x[b])
                        for b in range(nb)])
    angle, desc = torch.stack(angle), torch.stack(desc)

    # level coords -> level-0 coords, pixel-centre convention
    sc = scales[kp_l]
    x0 = (kp_x.to(torch.float32) + 0.5) * sc - 0.5
    y0 = (kp_y.to(torch.float32) + 0.5) * sc - 0.5
    xy = torch.stack([x0, y0], dim=-1)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    feats = Features(
        xy=torch.where(kp_valid[..., None], xy, zero),
        level=torch.where(kp_valid, kp_l, -1).to(torch.int32),
        score=top_s,
        angle=torch.where(kp_valid, angle, zero),
        desc=desc * kp_valid[..., None].to(torch.int8),
        valid=kp_valid,
    )
    if return_canvas:
        return feats, canvas
    return feats


def extract_orb(img: torch.Tensor, threshold: float,
                max_kp: int = MAX_KP_DEFAULT,
                n_levels: int = pyramid.N_LEVELS,
                return_canvas: bool = False):
    """ORB features of one (H, W) image (reference :92-157): Features
    without an eye axis; with `return_canvas` also its (L, H, W) pyramid
    canvas. A batch of one through `extract_orb_stereo`: kernel 1 launches
    once per call on the card."""
    out = extract_orb_stereo(img[None], threshold, max_kp=max_kp,
                             n_levels=n_levels, return_canvas=return_canvas)
    feats, canvas = out if return_canvas else (out, None)
    one = Features(*(getattr(feats, f.name)[0] for f in fields(Features)))
    return (one, canvas[0]) if return_canvas else one


def extract_orb_mono(img: torch.Tensor, threshold: float,
                     max_kp: int = MAX_KP_DEFAULT,
                     n_levels: int = pyramid.N_LEVELS) -> Features:
    """One (H, W) image through `extract_orb_stereo` as a batch of one
    (reference :174-186): Features with a leading eye axis of 1, kernel 1
    in one launch over the image's levels. The monocular and RGB-D
    trackers extract once per frame through it."""
    return extract_orb_stereo(img[None], threshold, max_kp=max_kp, n_levels=n_levels)


class ThresholdController:
    """Host-side dynamic FAST-threshold feedback loop (a copy of the
    reference's; orbslam_dsp_hwa_pipeline.h:15-19 regulates toward a target
    feature count). Log-proportional update with asymmetric gains: a
    too-high threshold starves the tracker, a too-low one merely over-fills
    the fixed budget, so down-regulation is stronger."""

    def __init__(self, target: int = 170, band: int = 30,
                 t0: float = 17.0, t_min: float = 5.0, t_max: float = 80.0,
                 gain: float = 0.15, gain_down: float = 0.6):
        self.target, self.band = target, band
        self.t, self.t_min, self.t_max, self.gain = t0, t_min, t_max, gain
        self.gain_down = gain_down

    def update(self, n_features: int) -> float:
        err = n_features - self.target
        if abs(err) > self.band:
            ratio = max(n_features, 1) / max(self.target, 1)
            g = self.gain if err > 0 else self.gain_down
            self.t *= float(np.clip(ratio ** g, 0.5, 1.2))
            self.t = float(np.clip(self.t, self.t_min, self.t_max))
        return self.t
