"""The Hamming distance matrix of binary descriptors as plain PyTorch (port
of `orbslam3lib_tpu/ops/matcher.py`): the stereo matcher's descriptor term,
plain on the card too (no kernel computes it).
"""
from __future__ import annotations

import torch

from .masks import BIG



def hamming_matrix(a_bits: torch.Tensor, b_bits: torch.Tensor,
                   a_valid: torch.Tensor | None = None,
                   b_valid: torch.Tensor | None = None) -> torch.Tensor:
    """(..., Na, 256) x (..., Nb, 256) 0/1 int8 -> (..., Na, Nb) f32 Hamming
    distances, sa + sb - 2 a.b (leading dims broadcast); invalid rows/columns
    are pushed to >= BIG. The product of 0/1 values is exact in f32 (sums <=
    256, TF32 off)."""
    a = a_bits.to(torch.float32)
    b = b_bits.to(torch.float32)
    d = a.sum(dim=-1)[..., :, None] + b.sum(dim=-1)[..., None, :] \
        - 2.0 * (a @ b.transpose(-1, -2))
    if a_valid is not None:
        d = d + (1.0 - a_valid.to(torch.float32))[..., :, None] * BIG
    if b_valid is not None:
        d = d + (1.0 - b_valid.to(torch.float32))[..., None, :] * BIG
    return d
