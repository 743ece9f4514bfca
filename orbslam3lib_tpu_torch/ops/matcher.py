"""Brute-force Hamming kNN-2 as plain PyTorch (port of
`orbslam3lib_tpu/ops/matcher.py:33-77`).

`knn_match` is the CPU path and the oracle of the CUDA kernel in
`ops/cuda_matcher.py`. `hamming_matrix` stays plain on the card too: the JAX
package computes it outside any Pallas kernel (projection search, stereo
matching).
"""
from __future__ import annotations

import torch

from .masks import BIG, step01


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


def knn2(dist: torch.Tensor):
    """Per row of the last dim: (best_idx int32, best_dist, second_dist); the
    argmin is the first (lowest) index, and the second distance is the min
    over the other columns (the best column penalised by BIG)."""
    best = torch.argmin(dist, dim=-1)
    d1 = torch.amin(dist, dim=-1)
    cols = torch.arange(dist.shape[-1], device=dist.device)
    not_best = step01((cols - best[..., None]).abs().to(torch.float32))
    d2 = torch.amin(dist + (1.0 - not_best) * BIG, dim=-1)
    return best.to(torch.int32), d1, d2


def mutual_best(dist: torch.Tensor):
    """Mutual nearest neighbours of a (Na, Nb) distance matrix: each row's
    best column (the lowest on ties) and whether that column's best row is
    the row itself (SearchForInitialization-style)."""
    best_ab = torch.argmin(dist, dim=1)
    best_ba = torch.argmin(dist, dim=0)
    agree = best_ba[best_ab] == torch.arange(dist.shape[0], device=dist.device)
    return best_ab, agree


def knn_match(a_bits, b_bits, a_valid=None, b_valid=None):
    """Full kNN-2 brute-force match a -> b: (best (Na,) int32, d1, d2 f32)."""
    return knn2(hamming_matrix(a_bits, b_bits, a_valid, b_valid))
