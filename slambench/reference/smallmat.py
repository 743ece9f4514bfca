"""Closed-form batched small-matrix solves (port of
`orbslam3lib_tpu/utils/smallmat.py`).

`inv3` inverts the LM-damped (3, 3) landmark blocks inside every local-BA
iteration (`mapping/local_ba._schur_solve`). Elementwise arithmetic,
batched over leading dims.
"""
from __future__ import annotations

import torch


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices via the adjugate. No pivoting: meant
    for well-conditioned blocks; singular inputs give inf/nan."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A00 = e * i - f * h
    A10 = f * g - d * i
    A20 = d * h - e * g
    A01 = c * h - b * i
    A11 = a * i - c * g
    A21 = b * g - a * h
    A02 = b * f - c * e
    A12 = c * d - a * f
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    adj = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A10, A11, A12], -1),
                       torch.stack([A20, A21, A22], -1)], -2)
    return adj / det[..., None, None]


