"""Two-view reconstruction for monocular initialisation (port of
`orbslam3lib_tpu/mapping/twoview.py`; ORB-SLAM3's TwoViewReconstruction:
8-point F and 4-point H RANSAC with sigma-scored symmetric errors, model
scores, the four (R, t) candidates of E with the cheirality check and
triangulation, Tracking.cc:2505).

As the reference, the 200 hypotheses are one batch: one batched SVD of
their (200, 8, 9) systems for F (`full_matrices=True`: the null vector of
an 8x9 system is the 9th right singular vector, which the thin SVD leaves
out) and of their (200, 8, 9) 4-point systems for H, then every hypothesis
scored at once; the four (R, t) candidates are checked as one batch too.
The SVDs' signs are arbitrary: F's scores, H after its division by H[2, 2]
and the set of candidates do not depend on them, but the candidates' order
does, so callers compare the selected (R, t), never its index.

The hypotheses' samples come from `utils/sampling.ransac_indices` (the
reference's `jax.random.choice` draws cannot be reproduced; tests pass them
in as `hyp_idx`). Like the reference's (:120), they are drawn with
replacement, so a sample may repeat a match (49 of 200 on one corridor
initialisation). Such a sample's 8-point system has rank 7: its null space
is a pencil of fundamental matrices, and the one the SVD returns is set by
its rounding, so LAPACK and cuSOLVER score it apart and either may make it
the best. The reference lets it win (ROADMAP queue 3); here a sample that
repeats a match scores -inf for F, and one that repeats among its first 4
for H.
"""
from __future__ import annotations

import torch

from ..utils import cameras
from ..utils.sampling import ransac_indices


def _normalize(pts: torch.Tensor):
    """Hartley normalisation of (N, 2) points over all N rows: zero mean,
    mean absolute deviation 1. Returns (normalised points, 3x3 T)."""
    mu = torch.mean(pts, dim=0)
    d = torch.mean(torch.abs(pts - mu), dim=0)
    s = 1.0 / torch.clamp(d, min=1e-9)
    T = torch.eye(3, dtype=pts.dtype, device=pts.device)
    T[0, 0], T[1, 1] = s[0], s[1]
    T[0, 2], T[1, 2] = -mu[0] * s[0], -mu[1] * s[1]
    return (pts - mu) * s, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of each
    (..., S, 9) system, as (..., 3, 3)."""
    full = A.shape[-2] < A.shape[-1]
    vt = torch.linalg.svd(A, full_matrices=full).Vh
    return vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _eight_point_F(x1: torch.Tensor, x2: torch.Tensor, w=None) -> torch.Tensor:
    """(..., S, 2), (..., S, 2) normalised points -> (..., 3, 3) rank-2
    fundamental matrices; optional row weights w (..., S) (the inlier
    re-fit on all matches)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    if w is not None:
        A = A * w[..., None]
    U, D, Vt = torch.linalg.svd(_null_vector(A))
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
    return U @ torch.diag_embed(D) @ Vt


def _four_point_H(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2), (..., 4, 2) -> (..., 3, 3) homographies x2 ~ H x1."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.stack([r1, r2], dim=-2).reshape(x1.shape[:-2] + (-1, 9))
    return _null_vector(A)


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=1)


def _score_F(F: torch.Tensor, p1, p2, valid, sigma: float = 1.0):
    """CheckFundamental: symmetric epipolar chi2, threshold 3.841, capped
    contribution 5.991, for (..., 3, 3) F. Returns (score (...,),
    inlier (..., N))."""
    x1, x2 = _homogeneous(p1), _homogeneous(p2)
    l2 = x1 @ F.transpose(-1, -2)      # lines in image 2
    l1 = x2 @ F                        # lines in image 1
    s2 = (torch.sum(l2 * x2, -1) ** 2) / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    s1 = (torch.sum(l1 * x1, -1) ** 2) / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    inv_s2 = 1.0 / (sigma * sigma)
    return _score(s1 * inv_s2, s2 * inv_s2, valid, 3.841)


def _score(c1, c2, valid, th: float):
    """The reference's soft inlier gates and capped chi2 score."""
    v = valid.to(torch.float32)
    in1 = torch.clamp(th - c1 + 1.0, 0.0, 1.0)
    in2 = torch.clamp(th - c2 + 1.0, 0.0, 1.0)
    score = torch.sum(v * (in1 * (5.991 - c1) + in2 * (5.991 - c2)), -1)
    return score, (v * in1 * in2) > 0.5


def _transfer(H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    Hx = x @ H.transpose(-1, -2)
    w = Hx[..., 2:]
    return Hx[..., :2] / torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)


def _score_H(H: torch.Tensor, p1, p2, valid, sigma: float = 1.0):
    """CheckHomography: symmetric transfer chi2, threshold 5.991."""
    x1, x2 = _homogeneous(p1), _homogeneous(p2)
    Hx1 = _transfer(H, x1)
    Hx2 = _transfer(torch.linalg.inv(H), x2)
    c1 = torch.sum((Hx2 - p1) ** 2, -1) / (sigma * sigma)
    c2 = torch.sum((Hx1 - p2) ** 2, -1) / (sigma * sigma)
    return _score(c1, c2, valid, 5.991)


def _scale_by(M: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return M / d[..., None, None]


def _repeats(idx: torch.Tensor) -> torch.Tensor:
    """(H, S) sample indices -> (H,) bool: the sample draws a match twice."""
    srt = torch.sort(idx, dim=-1).values
    return torch.any(srt[:, 1:] == srt[:, :-1], dim=-1)


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, gathered on the device (no host read)."""
    return x.index_select(0, i.reshape(1))[0]


def reconstruct_two_views(uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                          cam_params: torch.Tensor, n_hyp: int = 200,
                          sigma: float = 1.0, seed: int = 0, hyp_idx=None) -> dict:
    """Monocular initialisation from matched keypoints (pinhole; reference
    :107-228). uv1 / uv2 (N, 2) pixel matches, valid (N,). Returns
    {"success" (bool), "R", "t" (unit norm): camera 2's pose in camera 1's
    frame, "p3d" (N, 3) in camera 1's frame, "tri_ok" (N,), "n_good",
    "ratio_H"}, all tensors on uv1's device; nothing is read back."""
    N = uv1.shape[0]
    idx = ransac_indices(valid, n_hyp, 8, seed, hyp_idx=hyp_idx)
    n1, T1 = _normalize(uv1)
    n2, T2 = _normalize(uv2)

    Fn = _eight_point_F(n1[idx], n2[idx])
    Fs = T2.T @ Fn @ T1
    Fs = _scale_by(Fs, torch.clamp(torch.abs(Fs[:, 2, 2]), min=1e-12))
    Hn = _four_point_H(n1[idx[:, :4]], n2[idx[:, :4]])
    Hs = torch.linalg.inv(T2) @ Hn @ T1
    h22 = Hs[:, 2, 2]
    Hs = _scale_by(Hs, torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22))
    sF, inlF = _score_F(Fs, uv1, uv2, valid, sigma)
    sH, _ = _score_H(Hs, uv1, uv2, valid, sigma)
    # a rank-deficient sample's model is rounding: it never wins
    sF = torch.where(_repeats(idx), torch.full_like(sF, -float("inf")), sF)
    sH = torch.where(_repeats(idx[:, :4]), torch.full_like(sH, -float("inf")), sH)
    bF = torch.argmax(sF)
    ratio_H = torch.amax(sH) / torch.clamp(torch.amax(sH) + torch.amax(sF), min=1e-9)

    # re-fit F on the best hypothesis' inliers, twice
    inl_fit = _pick(inlF, bF)
    for _ in range(2):
        F = T2.T @ _eight_point_F(n1, n2, inl_fit.to(torch.float32)) @ T1
        F = F / torch.clamp(torch.abs(F[2, 2]), min=1e-12)
        _, inl_fit = _score_F(F, uv1, uv2, valid, sigma)

    # E from F, its four (R, t) candidates (ReconstructF)
    K = torch.eye(3, dtype=uv1.dtype, device=uv1.device)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = cam_params[0], cam_params[1], cam_params[2], \
        cam_params[3]
    U, _, Vt = torch.linalg.svd(K.T @ F @ K)
    W = torch.zeros((3, 3), dtype=uv1.dtype, device=uv1.device)
    W[0, 1], W[1, 0], W[2, 2] = -1.0, 1.0, 1.0
    R1 = U @ W @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = U @ W.T @ Vt
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tu = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=1e-12)
    R21 = torch.stack([R1, R1, R2, R2])                    # (4, 3, 3)
    t21 = torch.stack([tu, -tu, tu, -tu])                  # (4, 3)

    # each candidate: triangulate in camera 1 (camera 2 at R21, t21), then
    # the cheirality, parallax and reprojection gates (CheckRT)
    ray1 = cameras.pinhole_unproject(cam_params, uv1)
    ray2 = cameras.pinhole_unproject(cam_params, uv2)
    R12 = R21.transpose(-1, -2)
    t12 = -torch.einsum("kij,kj->ki", R12, t21)
    p3d, cosp, z1, z2 = cameras.triangulate_two_view(
        ray1.expand(4, N, 3), ray2.expand(4, N, 3), R12[:, None].expand(4, N, 3, 3),
        t12[:, None].expand(4, N, 3))
    uv1_hat = cameras.pinhole_project(cam_params, p3d)
    p_c2 = torch.einsum("kij,knj->kni", R21, p3d) + t21[:, None]
    uv2_hat = cameras.pinhole_project(cam_params, p_c2)
    e1 = torch.sum((uv1_hat - uv1) ** 2, -1)
    e2 = torch.sum((uv2_hat - uv2) ** 2, -1)
    max_e = 4.0 * sigma * sigma * 5.991
    ok = inl_fit & (z1 > 0.01) & (z2 > 0.01) & (cosp < 0.99998) & (e1 < max_e) & (e2 < max_e)
    counts = torch.sum(ok.to(torch.int32), -1)             # (4,)
    # the cosine of the 50th-largest parallax among the good points
    cos_sorted = torch.sort(torch.where(ok, cosp, torch.ones_like(cosp)), dim=-1).values
    idx50 = torch.clamp(torch.clamp(counts, max=50) - 1, 0, N - 1)
    cos50 = torch.gather(cos_sorted, 1, idx50[:, None].long())[:, 0]

    best = torch.argmax(counts)
    n_good = _pick(counts, best)
    n_valid = torch.sum(valid.to(torch.int32))
    second = torch.sort(counts).values[-2]
    # acceptance (ReconstructF): a clear winner with enough good points, and
    # at least 1 degree of parallax
    success = ((n_good > 0.7 * torch.clamp(n_valid, min=1))
               | ((n_good > 50) & (second < 0.75 * n_good))) & (_pick(cos50, best) < 0.99985)
    return {"success": success, "R": _pick(R21, best), "t": _pick(t21, best),
            "p3d": _pick(p3d, best), "tri_ok": _pick(ok, best), "n_good": n_good,
            "ratio_H": ratio_H}
