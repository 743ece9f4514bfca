"""Arithmetic gating masks (port of `orbslam3lib_tpu/ops/masks.py`).

The JAX package writes its gates as float arithmetic in [0, 1] because
boolean 2-D tensors hit a compiler pathology on the TPU. The port has no
such reason, but keeps the arithmetic all the same: the gate VALUES flow on
(fractional `visible` accumulates into `mp_visible`, soft-gated distances
decide argmin ties), so swapping in booleans would change results.
"""
from __future__ import annotations

import torch

BIG = 4096.0  # penalty for masked-out entries (>> max Hamming distance 256)


def step01(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1): 1 where x >= 1, 0 where x <= 0."""
    return torch.clamp(x, 0.0, 1.0)


def leq_int(x: torch.Tensor, th: float) -> torch.Tensor:
    """Exact gate x <= th for integer-valued float x."""
    return step01(th - x + 1.0)


def penalize(d: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Masked distances: keep d where gate ~ 1, push to >= BIG where ~ 0."""
    return d + (1.0 - gate) * BIG


def is_finite_match(best_d: torch.Tensor) -> torch.Tensor:
    """Gate 'best distance came from a real candidate' (< BIG/2 margin)."""
    return step01((2048.0 - best_d) * (1.0 / 1024.0))
