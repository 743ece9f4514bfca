"""Association searches: projection matching and rectified stereo matching
(port of `orbslam3lib_tpu/tracking/matching.py`).

Same dense formulation as the reference: spatial, level and descriptor gates
are (P, N) float matrices in [0, 1] (`ops/masks.py`), the descriptor term is
one Hamming product, and the argmin runs over the penalised distances, so
ties fall as in the reference (first index).

Constants follow ORB-SLAM: TH_HIGH=100, TH_LOW=50 (ORBmatcher.cc:36-38),
stereo descriptor gate (TH_HIGH+TH_LOW)/2=75, and the fisheye stereo gate
TH_FISHEYE=70 (Frame.cc:1169-1177).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda_matcher import knn_match_fused
from ..ops.fast import topk_stable
from ..ops.masks import BIG, is_finite_match, leq_int, penalize, step01
from ..ops.matcher import hamming_matrix
from ..ops.orient_brief import gather_patches
from ..ops.pyramid import level_shapes, scale_factors_on
from ..utils import cameras, lie

TH_HIGH = 100.0
TH_LOW = 50.0
TH_STEREO_DESC = 75.0
TH_FISHEYE = 70.0
NN_RATIO_DEFAULT = 0.9
HISTO_LENGTH = 30   # rotation-consistency bins (ORBmatcher.cc:38)


class ProjMatches(NamedTuple):
    """mp_feat (P,) int32: matched feature slot per landmark (-1 = none);
    visible (P,) f32: frustum-gate value in [0, 1] (for mp_visible)."""
    mp_feat: torch.Tensor
    visible: torch.Tensor


def _scales(n_levels: int, device) -> torch.Tensor:
    return scale_factors_on(n_levels, device)


def _one_to_one(dm: torch.Tensor) -> torch.Tensor:
    """Resolve a penalised (P, N) distance matrix to one-to-one matches: each
    landmark picks its best feature; each feature keeps the closest landmark
    that picked it, the first landmark on exact ties. Returns (P,) int32."""
    P, N = dm.shape
    dev = dm.device
    best_feat = torch.argmin(dm, dim=1)
    best_d = torch.amin(dm, dim=1)
    has = is_finite_match(best_d)
    tgt = torch.where(has > 0.5, best_feat, N)
    feat_min = torch.full((N + 1,), BIG, device=dev).scatter_reduce(
        0, tgt, best_d, reduce="amin")
    win = has * step01((feat_min[best_feat] + 1e-3) - best_d + 0.5)
    rows = torch.arange(P, device=dev)
    order = torch.where(win > 0.5, rows, P)
    first = torch.full((N + 1,), P, device=dev).scatter_reduce(
        0, tgt, order, reduce="amin")
    winner = (win > 0.5) & (first[best_feat] == rows)
    return torch.where(winner, best_feat, -1).to(torch.int32)


def predicted_level(dist: torch.Tensor, max_dist: torch.Tensor,
                    n_levels: int = 8) -> torch.Tensor:
    """MapPoint::PredictScale: the level whose scale matches the viewing
    distance (log ratio against the per-level scale chain)."""
    sf = _scales(n_levels, dist.device)
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1.0)
    err = torch.abs(torch.log(ratio[..., None]) - torch.log(sf)[None, :])
    return torch.argmin(err, dim=-1).to(torch.int32)


def search_by_projection(mp_pos, mp_desc, mp_valid, mp_normal, mp_min_dist,
                         mp_max_dist, R, t, cam_params, feat_xy, feat_level,
                         feat_desc, feat_valid, radius: float,
                         cam_model: int = cameras.PINHOLE,
                         img_w: int = 640, img_h: int = 400,
                         th_desc: float = TH_HIGH, n_levels: int = 8,
                         check_view_angle: bool = True) -> ProjMatches:
    """Project landmarks into the frame and match them to features
    (ORBmatcher::SearchByProjection + Frame::isInFrustum semantics)."""
    p_c = lie.se3_apply(R, t, mp_pos)
    z = p_c[..., 2]
    uv = cameras.project(cam_model, cam_params, p_c)
    dist = torch.linalg.norm(p_c, dim=-1)

    vis = mp_valid.to(torch.float32)
    vis = vis * step01(uv[..., 0] + 1.0) * step01(img_w - uv[..., 0])
    vis = vis * step01(uv[..., 1] + 1.0) * step01(img_h - uv[..., 1])
    vis = vis * step01((z - 0.1) * 10.0)
    # landmarks without scale-band info (unset 1e9 sentinel) skip the band
    # gate and predict level 0
    band = (mp_max_dist > 0) & (mp_max_dist < 1e8)
    has_band = band.to(torch.float32)
    vis = vis * (1.0 - has_band
                 + has_band * step01((dist - 0.8 * mp_min_dist) * 8.0)
                 * step01((1.2 * mp_max_dist - dist) * 8.0))
    if check_view_angle:
        _, cw = lie.se3_inverse(R, t)
        view = mp_pos - cw
        view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True), min=1e-9)
        cosang = torch.sum(view * mp_normal, dim=-1)
        vis = vis * step01((cosang - 0.5) * 8.0)

    lvl = torch.where(band, predicted_level(dist, mp_max_dist, n_levels), 0)
    r_scaled = radius * _scales(n_levels, mp_pos.device)[lvl.long()]

    d2 = torch.sum((uv[:, None, :] - feat_xy[None, :, :]) ** 2, dim=-1)
    g = step01(r_scaled[:, None] ** 2 - d2 + 1.0)
    dlvl = torch.abs(feat_level[None, :] - lvl[:, None]).to(torch.float32)
    g = g * step01(2.0 - dlvl)
    g = g * vis[:, None] * feat_valid.to(torch.float32)[None, :]

    desc_d = hamming_matrix(mp_desc, feat_desc)
    g = g * leq_int(desc_d, th_desc)
    mp_feat = _one_to_one(penalize(desc_d, g))
    return ProjMatches(mp_feat=mp_feat, visible=vis)


def match_rectified_stereo(xy_l, level_l, desc_l, valid_l,
                           xy_r, level_r, desc_r, valid_r,
                           bf: float, min_z: float, n_levels: int = 8):
    """Rectified stereo matching (Frame::ComputeStereoMatches semantics):
    right candidates within +-2*scale rows, disparity in (0, bf/min_z],
    descriptor gate 75. Returns (u_right (N,), depth (N,)), -1 / 0 where
    unmatched."""
    sf = _scales(n_levels, xy_l.device)
    row_tol = 2.0 * sf[torch.clamp(level_l, 0, n_levels - 1).long()]
    dv = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    max_disp = bf / min_z

    g = step01(row_tol[:, None] - dv + 1.0)
    g = g * step01((disp - 0.1) * 4.0)
    g = g * step01((max_disp - disp) + 1.0)
    g = g * valid_l.to(torch.float32)[:, None] * valid_r.to(torch.float32)[None, :]
    dlvl = torch.abs(level_l[:, None] - level_r[None, :]).to(torch.float32)
    g = g * step01(2.0 - dlvl)

    d = hamming_matrix(desc_l, desc_r)
    g = g * leq_int(d, TH_STEREO_DESC)
    dm = penalize(d, g)

    best = torch.argmin(dm, dim=1)
    best_d = torch.amin(dm, dim=1)
    has = is_finite_match(best_d)
    u_r = has * xy_r[best, 0] + (1.0 - has) * (-1.0)
    disparity = (xy_l[:, 0] - u_r) * has
    depth = has * step01((disparity - 0.1) * 100.0) * bf / torch.clamp(disparity, min=0.1)
    return u_r, depth


def match_fisheye_stereo(xy_l, desc_l, valid_l, xy_r, desc_r, valid_r,
                         cam_params_l, cam_params_r, R_lr, t_lr, bf: float):
    """Two-camera (non-rectified, Kannala-Brandt) stereo matching and
    triangulation (reference :185-221; Frame::ComputeStereoFishEyeMatches,
    Frame.cc:1142-1251, with KannalaBrandt8::TriangulateMatches).

    Each left feature takes its nearest right descriptor (the first on
    ties), kept when the distance is <= TH_FISHEYE (the code's gate; its
    docstring's "< 70" is not what runs); the pair is triangulated from the
    two KB8 rays and kept when the rays are not parallel (cos < 0.9998), the
    point lies in front of both cameras (z > 0.05) and reprojects within
    5.991 px^2 in both views. R_lr/t_lr: pose of the right camera in the
    left frame (x_l = R_lr x_r + t_lr). Returns (u_r, depth) in the
    rectified-path contract: depth is the left camera's z of the point and
    u_r the virtual coordinate u - bf/z (-1 and 0 where unmatched)."""
    d = hamming_matrix(desc_l, desc_r, valid_l, valid_r)
    best = torch.argmin(d, dim=1)
    d1 = torch.amin(d, dim=1)
    ok = valid_l & (d1 <= TH_FISHEYE)
    xy_rb = xy_r[best]
    ray_l = cameras.kb8_unproject(cam_params_l, xy_l)
    ray_r = cameras.kb8_unproject(cam_params_r, xy_rb)
    p3d, _, z1, z2 = cameras.triangulate_two_view(ray_l, ray_r, R_lr, t_lr)
    # the parallax cosine with its products fused into the sum, as the
    # reference's compiled graph computes it: the gate sits at f32(0.9998),
    # where close stereo pairs of a real frame land to the last ulp
    # (`triangulate_two_view` returns the unfused sum its other callers need)
    r1 = ray_l / torch.linalg.norm(ray_l, dim=-1, keepdim=True)
    r2 = torch.einsum("ij,nj->ni", R_lr, ray_r)
    r2 = r2 / torch.linalg.norm(r2, dim=-1, keepdim=True)
    cosp = torch.addcmul(torch.addcmul(r1[:, 0] * r2[:, 0], r1[:, 1], r2[:, 1]),
                         r1[:, 2], r2[:, 2])
    ok = ok & (cosp < 0.9998) & (z1 > 0.05) & (z2 > 0.05)
    e_l = torch.sum((cameras.kb8_project(cam_params_l, p3d) - xy_l) ** 2, dim=-1)
    p_r = torch.einsum("ij,nj->ni", R_lr.T, p3d - t_lr[None, :])
    e_r = torch.sum((cameras.kb8_project(cam_params_r, p_r) - xy_rb) ** 2, dim=-1)
    ok = ok & (e_l < 5.991) & (e_r < 5.991)
    depth = torch.where(ok, p3d[:, 2], torch.zeros_like(z1))
    u_r = torch.where(ok, xy_l[:, 0] - bf / torch.clamp(depth, min=1e-3),
                      torch.full_like(z1, -1.0))
    return u_r, depth


def refine_stereo_sad(canvas_l, canvas_r, xy_l, level_l, valid_l, u_r, depth,
                      bf: float, min_z: float, n_levels: int = 8):
    """Sub-pixel SAD refinement of rectified stereo matches (the refinement
    stage of Frame::ComputeStereoMatches, Frame.cc:897-997): an 11x11
    centre-normalised SAD sweep over +-5 px at the left keypoint's level,
    parabolic fit on the best triplet, disparity window, and the outlier cut
    at 1.5 * 1.4 * median(best SAD). Returns refined (u_r, depth)."""
    W_R, SRCH = 5, 5
    Lh, Hh, Wh = canvas_l.shape
    N = xy_l.shape[0]
    dev = xy_l.device
    sf = _scales(n_levels, dev)
    lvl = torch.clamp(level_l, 0, n_levels - 1).long()
    sc = sf[lvl]

    matched = (u_r >= 0.0) & valid_l
    xl = (xy_l[:, 0] + 0.5) / sc - 0.5
    yl = (xy_l[:, 1] + 0.5) / sc - 0.5
    xr0 = (u_r + 0.5) / sc - 0.5
    xi = torch.round(xl).to(torch.int64)
    yi = torch.round(yl).to(torch.int64)
    ri = torch.round(xr0).to(torch.int64)

    shp = torch.as_tensor(np.asarray(level_shapes(Hh, Wh, n_levels)), device=dev)
    lh, lw = shp[lvl, 0], shp[lvl, 1]
    pad = W_R + SRCH + 1
    ok = matched & (xi >= pad) & (xi < lw - pad) & \
        (yi >= pad) & (yi < lh - pad) & (ri >= pad) & (ri < lw - pad)
    xi = torch.clamp(xi, pad, Wh - pad - 1)
    yi = torch.clamp(yi, pad, Hh - pad - 1)
    ri = torch.clamp(ri, pad, Wh - pad - 1)

    pl = gather_patches(canvas_l, lvl, yi - W_R, xi - W_R, 2 * W_R + 1, 2 * W_R + 1)
    pl = pl - pl[:, W_R, W_R][:, None, None]
    strip = gather_patches(canvas_r, lvl, yi - W_R, ri - (W_R + SRCH),
                           2 * W_R + 1, 2 * (W_R + SRCH) + 1)

    def sad_at(inc):
        w = strip[:, :, inc + SRCH:inc + SRCH + 2 * W_R + 1]
        w = w - w[:, W_R, W_R][:, None, None]
        return torch.sum(torch.abs(pl - w), dim=(1, 2))

    sads = torch.stack([sad_at(i) for i in range(-SRCH, SRCH + 1)], dim=1)
    best = torch.argmin(sads, dim=1)
    best_in = torch.clamp(best, 1, 2 * SRCH - 1)
    ok = ok & (best >= 1) & (best <= 2 * SRCH - 1)
    iN = torch.arange(N, device=dev)
    dC = sads[iN, best_in]
    dL = sads[iN, best_in - 1]
    dRr = sads[iN, best_in + 1]
    denom = dL + dRr - 2.0 * dC
    delta = torch.where(torch.abs(denom) > 1e-6,
                        (dL - dRr) / (2.0 * torch.clamp(denom, min=1e-6)),
                        torch.zeros_like(denom))
    ok = ok & (torch.abs(delta) <= 1.0)

    xr_ref = ri.to(torch.float32) + (best_in - SRCH).to(torch.float32) + delta
    # the sweep measures the disparity at the rounded left position; assume a
    # locally constant disparity and re-anchor at the unrounded keypoint
    disp_lvl = xi.to(torch.float32) - xr_ref
    u_r_ref = xy_l[:, 0] - disp_lvl * sc
    disparity = xy_l[:, 0] - u_r_ref
    ok = ok & (disparity > 0.01) & (disparity <= bf / min_z)

    # outlier cut: sort-then-index median (the reference's tie rule; not
    # torch.median)
    n_ok = ok.sum()
    s_sorted = torch.sort(torch.where(ok, dC, torch.full_like(dC, float("inf")))).values
    med = s_sorted[torch.clamp(torch.div(n_ok - 1, 2, rounding_mode="floor"), 0, N - 1)]
    ok = ok & (dC <= 1.5 * 1.4 * med)

    u_out = torch.where(ok, u_r_ref, u_r)
    cut = matched & ~ok
    u_out = torch.where(cut, torch.full_like(u_out, -1.0), u_out)
    d_out = torch.where(ok, bf / torch.clamp(disparity, min=1e-3),
                        torch.where(cut, torch.zeros_like(depth), depth))
    return u_out, d_out


def rotation_consistency(angle_a, angle_b_matched, ok):
    """ORBmatcher's rotation-consistency histogram (ComputeThreeMaxima): keep
    only matches whose orientation delta falls in the three strongest of
    HISTO_LENGTH bins (bins below 0.1x the best are dropped). Batched over
    leading dims: each row of the last dim has its own histogram."""
    two_pi = 2.0 * np.pi
    rot = torch.remainder(angle_a - angle_b_matched, two_pi)
    b = torch.clamp((rot * (HISTO_LENGTH / two_pi)).to(torch.int64), 0, HISTO_LENGTH - 1)
    lead = b.shape[:-1]
    tgt = torch.where(ok, b, HISTO_LENGTH).reshape(-1, b.shape[-1])
    rows = torch.arange(tgt.shape[0], device=b.device)[:, None] * (HISTO_LENGTH + 1)
    hist = torch.zeros(tgt.shape[0] * (HISTO_LENGTH + 1), device=b.device).index_add_(
        0, (rows + tgt).reshape(-1), torch.ones(tgt.numel(), device=b.device))
    hist = hist.reshape(lead + (HISTO_LENGTH + 1,))[..., :HISTO_LENGTH]
    top_v, top_i = topk_stable(hist, 3)
    keep_bin = torch.zeros(lead + (HISTO_LENGTH,), dtype=torch.bool, device=b.device)
    keep_bin.scatter_(-1, top_i, top_v >= 0.1 * top_v[..., :1])
    return ok & torch.gather(keep_bin, -1, b)


def match_descriptors_ratio(desc_a, valid_a, desc_b, valid_b,
                            th: float = TH_LOW, ratio: float = NN_RATIO_DEFAULT):
    """Descriptor kNN-2 with Lowe ratio and threshold. Returns (idx (Na,)
    int32, -1 where rejected; ok (Na,) bool).

    On a CUDA tensor this runs kernel 2 (`ops/cuda_matcher.py`, the port of
    the TPU's fused kNN-2, `matching.py:381-387`); on the CPU the plain
    Hamming product + knn2, the kernel's oracle.
    """
    i1, d1, d2 = knn_match_fused(desc_a, desc_b, valid_a, valid_b)
    ok = valid_a & (d1 <= th) & (d1 <= ratio * d2)
    return torch.where(ok, i1, -1).to(torch.int32), ok
