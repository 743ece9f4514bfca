"""Rectified stereo matching and its SAD refinement (port of
`orbslam3lib_tpu/tracking/matching.py`).

Same dense formulation as the reference: row, level and descriptor gates
are (N, N) float matrices in [0, 1] (`ops/masks.py`), the descriptor term is
one Hamming product, and the argmin runs over the penalised distances, so
ties fall as in the reference (first index).

Constants follow ORB-SLAM: TH_HIGH=100, TH_LOW=50 (ORBmatcher.cc:36-38),
and the stereo descriptor gate (TH_HIGH+TH_LOW)/2=75.
"""
from __future__ import annotations

import torch

from .masks import is_finite_match, leq_int, penalize, step01
from .matcher import hamming_matrix
from .orient_brief import gather_patches
from .pyramid import level_shapes_on, scale_factors_on

TH_HIGH = 100.0
TH_LOW = 50.0
TH_STEREO_DESC = 75.0


def _scales(n_levels: int, device) -> torch.Tensor:
    return scale_factors_on(n_levels, device)


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

    shp = level_shapes_on(Hh, Wh, n_levels, dev)
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
    mid = torch.clamp(torch.div(n_ok - 1, 2, rounding_mode="floor"), 0, N - 1)
    med = s_sorted.index_select(0, mid.reshape(1))[0]   # no host read of the index
    ok = ok & (dC <= 1.5 * 1.4 * med)

    u_out = torch.where(ok, u_r_ref, u_r)
    cut = matched & ~ok
    u_out = torch.where(cut, torch.full_like(u_out, -1.0), u_out)
    d_out = torch.where(ok, bf / torch.clamp(disparity, min=1e-3),
                        torch.where(cut, torch.zeros_like(depth), depth))
    return u_out, d_out
