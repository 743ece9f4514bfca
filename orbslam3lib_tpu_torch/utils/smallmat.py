"""Closed-form batched small-matrix solves (port of
`orbslam3lib_tpu/utils/smallmat.py`).

`inv3` inverts the LM-damped (3, 3) landmark blocks inside every local-BA
iteration (`mapping/local_ba._schur_solve`); `adjugate4` and
`smallest_eigvec4_psd` are the SVD-free null-space step of DLT
triangulation. All are elementwise arithmetic, batched over leading dims.
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


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices by cofactor expansion (no LU, so
    nothing on the card checks a pivot)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def adjugate4(M: torch.Tensor) -> torch.Tensor:
    """Adjugate of (..., 4, 4) matrices (det(M) M^-1) by cofactor expansion
    over 2x2 minors."""
    m00, m01, m02, m03 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2], M[..., 0, 3]
    m10, m11, m12, m13 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2], M[..., 1, 3]
    m20, m21, m22, m23 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2], M[..., 2, 3]
    m30, m31, m32, m33 = M[..., 3, 0], M[..., 3, 1], M[..., 3, 2], M[..., 3, 3]
    s0 = m00 * m11 - m10 * m01
    s1 = m00 * m12 - m10 * m02
    s2 = m00 * m13 - m10 * m03
    s3 = m01 * m12 - m11 * m02
    s4 = m01 * m13 - m11 * m03
    s5 = m02 * m13 - m12 * m03
    c5 = m22 * m33 - m32 * m23
    c4 = m21 * m33 - m31 * m23
    c3 = m21 * m32 - m31 * m22
    c2 = m20 * m33 - m30 * m23
    c1 = m20 * m32 - m30 * m22
    c0 = m20 * m31 - m30 * m21
    a00 = m11 * c5 - m12 * c4 + m13 * c3
    a01 = -m01 * c5 + m02 * c4 - m03 * c3
    a02 = m31 * s5 - m32 * s4 + m33 * s3
    a03 = -m21 * s5 + m22 * s4 - m23 * s3
    a10 = -m10 * c5 + m12 * c2 - m13 * c1
    a11 = m00 * c5 - m02 * c2 + m03 * c1
    a12 = -m30 * s5 + m32 * s2 - m33 * s1
    a13 = m20 * s5 - m22 * s2 + m23 * s1
    a20 = m10 * c4 - m11 * c2 + m13 * c0
    a21 = -m00 * c4 + m01 * c2 - m03 * c0
    a22 = m30 * s4 - m31 * s2 + m33 * s0
    a23 = -m20 * s4 + m21 * s2 - m23 * s0
    a30 = -m10 * c3 + m11 * c1 - m12 * c0
    a31 = m00 * c3 - m01 * c1 + m02 * c0
    a32 = -m30 * s3 + m31 * s1 - m32 * s0
    a33 = m20 * s3 - m21 * s1 + m22 * s0
    return torch.stack([torch.stack([a00, a01, a02, a03], -1),
                        torch.stack([a10, a11, a12, a13], -1),
                        torch.stack([a20, a21, a22, a23], -1),
                        torch.stack([a30, a31, a32, a33], -1)], -2)


def smallest_eigvec4_psd(M: torch.Tensor, n_refine: int = 2) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of a (..., 4, 4) symmetric PSD
    matrix: the best column of adj(M), refined by multiplying with adj(M)
    `n_refine` times. Rank-deficient M (adj ~ 0) gives e_4, not NaN."""
    # normalise the scale so the cubic-in-M adjugate stays in f32 range; the
    # trace summed in jnp.trace's order on the CPU: on a near-singular M one
    # ulp of s moves the eigenvector by ~1e-5
    tr = (M[..., 0, 0] + M[..., 2, 2]) + (M[..., 1, 1] + M[..., 3, 3])
    s = torch.clamp(tr / 4.0, min=1e-20)
    A = adjugate4(M / s[..., None, None])
    # start from the column with the largest diagonal entry (adj is PSD too)
    j = torch.argmax(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
    idx = j[..., None, None].expand(j.shape + (4, 1))
    x = torch.take_along_dim(A, idx, dim=-1)[..., 0]
    e4 = torch.zeros_like(x)
    e4[..., 3] = 1.0

    def _norm(v):
        n = torch.linalg.norm(v, dim=-1, keepdim=True)
        return torch.where(n > 1e-12, v / torch.clamp(n, min=1e-30), e4)

    x = _norm(x)
    for _ in range(n_refine):
        x = _norm(torch.einsum("...ij,...j->...i", A, x))
    return x
