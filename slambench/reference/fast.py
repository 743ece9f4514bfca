"""FAST-9/16 corner scores, 3x3 NMS and per-tile top-K, as plain PyTorch
(port of `orbslam3lib_tpu/ops/fast.py`).

`nms3x3(fast_scores(img, margin))` is the CPU path of the detector and the
oracle of the CUDA kernel in `ops/cuda_fast.py`: both do only f32
subtractions, min and max on the same values, so they agree bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# FAST-16 Bresenham ring of radius 3, (dy, dx), standard order.
RING: Tuple[Tuple[int, int], ...] = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_scores(img: torch.Tensor, margin: int = 3) -> torch.Tensor:
    """Exact FAST-9/16 score map: the largest t for which a pixel is a
    corner, i.e. the max over the 16 arcs of 9 of min(ring - c) [bright] or
    min(c - ring) [dark], floored at 0. Rows and columns within `margin` of
    an edge are zeroed (ring samples wrap there).

    img: (..., H, W) float32. Returns (..., H, W) float32.
    """
    c = img
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1))
                        for dy, dx in RING], dim=0)

    def windowed_min(d):
        # circular windowed min of length 9 along the ring via log-doubling
        m = torch.minimum(d, torch.roll(d, -1, dims=0))
        m = torch.minimum(m, torch.roll(m, -2, dims=0))
        m = torch.minimum(m, torch.roll(m, -4, dims=0))
        return torch.minimum(m, torch.roll(d, -8, dims=0))

    bright = torch.amax(windowed_min(ring - c), dim=0)
    dark = torch.amax(windowed_min(c - ring), dim=0)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)

    h, w = img.shape[-2], img.shape[-1]
    ys = torch.arange(h, device=img.device)
    xs = torch.arange(w, device=img.device)
    valid = ((ys >= margin) & (ys < h - margin))[:, None] & \
        ((xs >= margin) & (xs < w - margin))[None, :]
    return torch.where(valid, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep a score only where it equals its 3x3 maximum (plateaus survive)."""
    lead = score.shape[:-2]
    x = score.reshape((-1, 1) + score.shape[-2:])
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    mx = F.max_pool2d(xp, 3, stride=1)
    out = torch.where(x >= mx, x, torch.zeros_like(x))
    return out.reshape(lead + score.shape[-2:])


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim, lowest index first among equal values.

    `jax.lax.top_k` and (on the CPU) `approx_max_k` break ties that way;
    `torch.topk` promises no order, and its order differs between the CPU
    and CUDA. FAST scores on level 0 are integers, so ties are everywhere
    and this order feeds every later argmin.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def tile_topk(score: torch.Tensor, tile_h: int, tile_w: int, k: int):
    """Per-tile top-K candidates over a score map.

    score: (..., H, W), zero-padded up to tile multiples. Returns
    (scores, ys, xs), each (..., T*k) with T the number of tiles (row-major);
    invalid slots carry score 0.
    """
    lead = score.shape[:-2]
    h, w = score.shape[-2:]
    ph, pw = (-h) % tile_h, (-w) % tile_w
    sp = F.pad(score, (0, pw, 0, ph))
    nty, ntx = (h + ph) // tile_h, (w + pw) // tile_w
    tiles = sp.reshape(lead + (nty, tile_h, ntx, tile_w)).transpose(-3, -2)
    tiles = tiles.reshape(lead + (nty * ntx, tile_h * tile_w))
    top_s, top_i = topk_stable(tiles, k)                  # (..., T, k)
    t = torch.arange(nty * ntx, device=score.device)[:, None]
    ys = (t // ntx) * tile_h + top_i // tile_w
    xs = (t % ntx) * tile_w + top_i % tile_w
    flat = lead + (-1,)
    return top_s.reshape(flat), ys.reshape(flat), xs.reshape(flat)
