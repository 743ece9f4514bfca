"""Image pyramid (port of `orbslam3lib_tpu/ops/pyramid.py`).

Geometry contract of the reference (orbslam_dsp_pyramid.h:37-66): level
widths {640,512,384,314,256,203,161,128} for a 640x400 input, each level
resized from the one before (chained bilinear reduction). The resize is the
same separable form as the reference: (H_out x H_in) @ img @ (W_in x W_out)
with the same host-built f32 interpolation matrices, so levels agree with
the JAX package to float rounding (about 1e-5 on 0..255 pixels).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

REF_WIDTHS = (640, 512, 384, 314, 256, 203, 161, 128)
REF_HEIGHTS = (400, 320, 240, 196, 160, 127, 101, 80)
N_LEVELS = 8


def level_shapes(h0: int = 400, w0: int = 640,
                 n_levels: int = N_LEVELS) -> List[Tuple[int, int]]:
    """Per-level (H, W): the reference table at 640x400, otherwise the same
    ratio chain."""
    if (h0, w0) == (400, 640) and n_levels == N_LEVELS:
        return list(zip(REF_HEIGHTS, REF_WIDTHS))
    shapes = [(h0, w0)]
    for lvl in range(1, n_levels):
        r = REF_WIDTHS[min(lvl, N_LEVELS - 1)] / REF_WIDTHS[0]
        shapes.append((max(8, int(round(h0 * r))), max(8, int(round(w0 * r)))))
    return shapes


def scale_factors(n_levels: int = N_LEVELS) -> np.ndarray:
    """Per-level absolute scale (level-0 pixels per level-L pixel)."""
    return np.asarray([REF_WIDTHS[0] / REF_WIDTHS[min(l, N_LEVELS - 1)]
                       for l in range(n_levels)], dtype=np.float32)


@lru_cache(maxsize=None)
def scale_factors_on(n_levels: int, device: torch.device) -> torch.Tensor:
    """`scale_factors` as a tensor on `device`, made once per device: a copy
    from the host on every call would wait for the card's queue."""
    return torch.from_numpy(scale_factors(n_levels)).to(device)


@lru_cache(maxsize=None)
def level_shapes_on(h0: int, w0: int, n_levels: int, device: torch.device) -> torch.Tensor:
    """`level_shapes` as an (L, 2) int64 tensor on `device`, made once per
    shape and device (no host copy, so no wait, per frame)."""
    return torch.as_tensor(np.asarray(level_shapes(h0, w0, n_levels)), device=device)


@lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bilinear interpolation matrix, pixel-centre
    convention (align-corners=False)."""
    M = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        frac = src - i0
        i0c = min(max(i0, 0), n_in - 1)
        i1c = min(max(i0 + 1, 0), n_in - 1)
        M[o, i0c] += 1.0 - frac
        M[o, i1c] += frac
    return M


@lru_cache(maxsize=None)
def _resize_pair(h_in: int, w_in: int, h_out: int, w_out: int,
                 device: torch.device):
    """(Mh, Mw^T) on `device`, copied there once per process."""
    return (torch.from_numpy(_resize_matrix(h_in, h_out)).to(device),
            torch.from_numpy(_resize_matrix(w_in, w_out).T.copy()).to(device))


def _resize_bilinear(img: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Separable bilinear resize of (..., H, W) float32 by two f32 matmuls."""
    Mh, MwT = _resize_pair(img.shape[-2], img.shape[-1], h_out, w_out, img.device)
    return (Mh @ img) @ MwT


def build_pyramid(img: torch.Tensor, n_levels: int = N_LEVELS) -> List[torch.Tensor]:
    """img (..., H, W) uint8 or float32 -> list of float32 levels, each
    level resized from the previous one."""
    shapes = level_shapes(img.shape[-2], img.shape[-1], n_levels)
    cur = img.to(torch.float32)
    levels = [cur]
    for lvl in range(1, n_levels):
        cur = _resize_bilinear(cur, *shapes[lvl])
        levels.append(cur)
    return levels
