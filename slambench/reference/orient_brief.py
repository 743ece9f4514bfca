"""Keypoint orientation (intensity centroid) and rotated BRIEF over 64 angle
bins (port of `orbslam3lib_tpu/ops/orient_brief.py`).

One 45x45 raw patch per keypoint feeds both: the moments m10/m01 over the
31x31 circular sub-patch (a dense (N, 2025) x (2025, 2) product), and the
descriptor, where the 7-tap Gaussian pre-blur is folded into the per-bin
compare matrices exactly as in the reference (`_compare_blur_matrices`).

Two departures in form, none in value:
  * patches come from a direct index gather, in place of the reference's
    one-hot matmul (`ops/patches.py`, a TPU workaround; both are exact);
  * the reference multiplies all 64 bins' (256, 2025) compare matrices with
    every patch and then selects each keypoint's bin. Each compare row has at
    most 98 non-zeros (two blurred 7x7 taps), so the port stores the rows
    sparsely and gathers only the selected bin: 256 x 98 products per
    keypoint instead of 64 x 256 x 2025.
The values match the reference's numerics: both the raw patch and the fused
compare matrix are rounded to bf16 (as `_bits_from_compare` does) and the
products are summed in f32, so a bit can differ only where the compare sum
sits at f32 accumulation noise.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .pattern import BIT_PATTERN_31

HALF_PATCH = 15          # orientation patch radius (31x31)
BRIEF_RADIUS = 19        # rotated pattern radius <= 18.39
BRIEF_PATCH = 2 * BRIEF_RADIUS + 1  # 39
BLUR_HALF = 3            # 7-tap Gaussian
RAW_RADIUS = BRIEF_RADIUS + BLUR_HALF   # 22 -> 45x45 raw patch
RAW_PATCH = 2 * RAW_RADIUS + 1
RAW_FLAT = RAW_PATCH * RAW_PATCH          # 2025
N_ANGLE_BINS = 64


@lru_cache(maxsize=None)
def _moment_weights_raw() -> np.ndarray:
    """(RAW_FLAT, 2) weights: (m10, m01) over the centred 31x31 circular
    sub-patch of the raw patch (reference umax semantics)."""
    v = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    vv, uu = np.meshgrid(v, v, indexing="ij")
    umax = np.round(np.sqrt(HALF_PATCH * HALF_PATCH - v * v + 0.0)).astype(np.int32)
    mask = (np.abs(uu) <= umax[:, None]).astype(np.float32)
    W = np.zeros((RAW_PATCH, RAW_PATCH, 2), np.float32)
    lo, hi = RAW_RADIUS - HALF_PATCH, RAW_RADIUS + HALF_PATCH + 1
    W[lo:hi, lo:hi, 0] = uu * mask
    W[lo:hi, lo:hi, 1] = vv * mask
    return W.reshape(-1, 2)


def _blur_matrix() -> np.ndarray:
    """(BRIEF_PATCH, RAW_PATCH) banded 7-tap Gaussian (sigma 2), valid conv."""
    xs = np.arange(-BLUR_HALF, BLUR_HALF + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / 2.0) ** 2)
    k /= k.sum()
    B = np.zeros((BRIEF_PATCH, RAW_PATCH), np.float32)
    for i in range(BRIEF_PATCH):
        B[i, i:i + 7] = k
    return B


def _compare_matrices() -> np.ndarray:
    """(A, 256, 39*39) +-1 compare matrices: +1 at the rotated pattern point
    1, -1 at point 2 (they cancel when the two collide)."""
    pat = BIT_PATTERN_31.astype(np.float64)
    A = N_ANGLE_BINS
    D = np.zeros((A, 256, BRIEF_PATCH * BRIEF_PATCH), np.float32)
    for a in range(A):
        th = 2.0 * np.pi * a / A
        ca, sa = np.cos(th), np.sin(th)
        for sgn, (cx, cy) in ((1.0, (0, 1)), (-1.0, (2, 3))):
            rx = np.round(pat[:, cx] * ca - pat[:, cy] * sa).astype(np.int64)
            ry = np.round(pat[:, cx] * sa + pat[:, cy] * ca).astype(np.int64)
            idx = (ry + BRIEF_RADIUS) * BRIEF_PATCH + (rx + BRIEF_RADIUS)
            D[a, np.arange(256), idx] += sgn
    return D


@lru_cache(maxsize=None)
def _sparse_compare_blur():
    """Sparse rows of the bf16-rounded fused blur+compare tensor:
    (idx (A, 256, K) int64 into the 2025-pixel raw patch, weight (A, 256, K)
    f32 holding bf16 values, zero-padded), K = most non-zeros in a row."""
    D = _compare_matrices().astype(np.float64)
    B = _blur_matrix().astype(np.float64)
    A = N_ANGLE_BINS
    Dm = D.reshape(A * 256, BRIEF_PATCH, BRIEF_PATCH)
    # D'[b] = B^T D[b] B: the reference's einsum("bil,ij,lk->bjk"), as two
    # matmuls (same f32 values, a second instead of a minute)
    Dp = (B.T @ Dm @ B).reshape(A * 256, RAW_FLAT)
    # the reference's f32 tensor, rounded to bf16 as its matmul consumes it
    Dbf = torch.from_numpy(Dp.astype(np.float32)).to(torch.bfloat16).float()
    nz = Dbf != 0
    K = int(nz.sum(dim=1).max())
    # non-zero columns first, in column order (stable sort on the mask)
    order = torch.sort((~nz).to(torch.int8), dim=1, stable=True).indices[:, :K]
    w = torch.gather(Dbf, 1, order)
    return order.reshape(A, 256, K), w.reshape(A, 256, K)


@lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """(moment weights, sparse compare idx, weights) on `device`, copied
    there once per process."""
    idx, wgt = _sparse_compare_blur()
    return (torch.from_numpy(_moment_weights_raw()).to(device),
            idx.to(device), wgt.to(device))


def bin_angles(angle: torch.Tensor) -> torch.Tensor:
    """Quantize angles (radians) to N_ANGLE_BINS bins (round half to even,
    as jnp.round)."""
    a = angle / (2.0 * np.pi / N_ANGLE_BINS)
    return torch.remainder(torch.round(a).to(torch.int64), N_ANGLE_BINS)


def gather_patches(canvas: torch.Tensor, level: torch.Tensor, y: torch.Tensor,
                   x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """canvas (L, H, W); level/y/x (N,) integer: (N, h, w) patches whose
    top-left corner is (y, x) on the keypoint's level. Rows clamp to the
    canvas and columns to the row, which only touches keypoints the callers'
    margins already exclude."""
    L, H, W = canvas.shape
    dy = torch.arange(h, device=canvas.device)
    dx = torch.arange(w, device=canvas.device)
    rows = (level.long()[:, None] * H + y.long()[:, None] + dy[None, :]).clamp(0, L * H - 1)
    cols = (x.long()[:, None] + dx[None, :]).clamp(0, W - 1)
    flat = rows[:, :, None] * W + cols[:, None, :]
    return canvas.reshape(-1)[flat]


def orient_and_brief(canvas: torch.Tensor, level: torch.Tensor,
                     y: torch.Tensor, x: torch.Tensor):
    """canvas (L, H, W) f32 pyramid canvas; level/y/x (N,) level-local
    keypoint coordinates. Returns (angle (N,) f32, desc (N, 256) int8 0/1)."""
    n = level.shape[0]
    patches = gather_patches(canvas, level, y - RAW_RADIUS, x - RAW_RADIUS,
                             RAW_PATCH, RAW_PATCH).reshape(n, RAW_FLAT)
    moments, idx, wgt = _device_tables(canvas.device)
    m = patches @ moments
    angle = torch.atan2(m[:, 1], m[:, 0])

    bins = bin_angles(angle)
    idx, wgt = idx[bins], wgt[bins]                        # (N, 256, K)
    p = patches.to(torch.bfloat16).to(torch.float32)
    vals = torch.gather(p, 1, idx.reshape(n, -1)).reshape(idx.shape)
    v = torch.sum(vals * wgt, dim=-1)                      # (N, 256)
    return angle, (v < 0).to(torch.int8)
