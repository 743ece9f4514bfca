"""Stereo rectification: host-side map precompute and the per-frame remap on
the card (port of `orbslam3lib_tpu/utils/rectify.py`).

`stereo_rectify` (Bouguet's algorithm, cv::stereoRectify semantics) and the
Catmull-Smith `twopass_maps` run once, on the host, in numpy; the sample
maps go through the port's f32 `cameras.project`, as the reference's go
through its jnp one. After rectification both eyes are ideal pinholes that
share one intrinsic matrix, rows are epipolar lines and the baseline is +x:
the contract of `matching.match_rectified_stereo`.

Per frame, `TwoPassRemap` computes the values of the reference's
`remap_bilinear_shifts` (the remap its tracker runs) as two 2-tap gathers:
a vertical pass at each output pixel's column of the two-pass map, then a
horizontal pass. The reference's shift-and-accumulate loop is a TPU
workaround for slow gathers; only two of its taps per axis carry weight, so
the gathers reproduce its sums. `remap_bilinear` is the exact direct
bilinear remap, the oracle of the tests.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cameras


class RectifyResult(NamedTuple):
    """Host-side rectification precompute."""
    maps: np.ndarray        # (2, H, W, 2) sample coords (x, y) per eye
    new_params: np.ndarray  # [fx, fy, cx, cy] shared rectified intrinsics
    baseline: float         # rectified baseline (metres)
    R_rect: np.ndarray      # (2, 3, 3) rect<-cam rotations (left, right)


def _so3_log(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-9:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (th / (2.0 * np.sin(th)))


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def stereo_rectify(params_l: np.ndarray, params_r: np.ndarray,
                   model_l: int, model_r: int,
                   R_lr: np.ndarray, t_lr: np.ndarray,
                   width: int, height: int) -> RectifyResult:
    """Bouguet stereo rectification (reference :54-107).

    params_l/r: distorted camera parameter vectors; R_lr/t_lr: pose of the
    right camera in the left frame (x_l = R x_r + t). Returns the per-eye
    sample maps (rectified pixel -> source pixel) and the shared rectified
    pinhole."""
    R_lr = np.asarray(R_lr, np.float64).reshape(3, 3)
    t_lr = np.asarray(t_lr, np.float64).reshape(3)
    # split the relative rotation evenly between the eyes
    om = _so3_log(R_lr)
    Ra0 = _so3_exp(-0.5 * om)
    Rb0 = Ra0 @ R_lr
    # align the baseline with +x in the shared orientation
    t_rl = -R_lr.T @ t_lr
    t_new = Rb0 @ t_rl
    b = np.linalg.norm(t_new)
    e1 = t_new / b
    if e1[0] < 0:
        e1 = -e1
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n2 < 1e-9 else e2 / n2
    e3 = np.cross(e1, e2)
    R_align = np.stack([e1, e2, e3], axis=0)
    Ra = R_align @ Ra0
    Rb = R_align @ Rb0

    # shared intrinsics: mean focal, image-centred principal point
    f_new = 0.25 * float(params_l[0] + params_l[1] + params_r[0] + params_r[1])
    cx_new, cy_new = width * 0.5, height * 0.5
    new_params = np.asarray([f_new, f_new, cx_new, cy_new], np.float32)

    u, v = np.meshgrid(np.arange(width, dtype=np.float32),
                       np.arange(height, dtype=np.float32))
    ray = np.stack([(u - cx_new) / f_new, (v - cy_new) / f_new,
                    np.ones_like(u)], axis=-1)          # (H, W, 3)
    maps = np.zeros((2, height, width, 2), np.float32)
    for eye, (Rr, prm, mdl) in enumerate(
            [(Ra, params_l, model_l), (Rb, params_r, model_r)]):
        x_cam = ray @ Rr.astype(np.float32)             # Rr^T applied rowwise
        uv_src = cameras.project(
            mdl, torch.from_numpy(np.asarray(prm, np.float32)),
            torch.from_numpy(np.ascontiguousarray(x_cam.reshape(-1, 3)))).numpy()
        maps[eye] = uv_src.reshape(height, width, 2)
    return RectifyResult(maps=maps, new_params=new_params, baseline=float(b),
                         R_rect=np.stack([Ra, Rb]).astype(np.float32))


OOB = -1.0e4   # sentinel source coordinate: always outside the image -> 0


def twopass_maps(mp) -> np.ndarray:
    """Direct remap map -> Catmull-Smith two-pass maps (reference
    :113-150). Direct: out[yo, xo] = img(Y(yo, xo), X(yo, xo)). Pass V:
    imgv[yo, x] = img(Yv(yo, x), x) with Yv(yo, x) = Y(yo, X^-1(yo, x));
    pass H: out[yo, xo] = imgv(yo, X(yo, xo)). Needs X increasing along
    rows. Returns the (..., H, W, 2) layout with [..., 0] = X and [..., 1] =
    Yv; out-of-image samples carry the OOB sentinel."""
    m = np.asarray(mp, np.float64)
    lead = m.shape[:-3]
    H, W = m.shape[-3], m.shape[-2]
    m2 = m.reshape((-1, H, W, 2)).copy()
    xs = np.arange(W, dtype=np.float64)
    for e in range(m2.shape[0]):
        X, Y = m2[e, ..., 0], m2[e, ..., 1]
        inb = (X >= 0) & (X <= W - 1) & (Y >= 0) & (Y <= H - 1)
        for yo in range(H):
            Xrow = X[yo]
            if not np.all(np.diff(Xrow) > 0):
                raise ValueError("twopass_maps requires X monotonic in x")
            xo_inv = np.interp(xs, Xrow, xs)
            m2[e, yo, :, 1] = np.interp(xo_inv, xs, Y[yo])
        m2[e, ..., 0] = np.where(inb, X, OOB)
        m2[e, ..., 1] = np.where(
            (m2[e, ..., 1] >= 0) & (m2[e, ..., 1] <= H - 1), m2[e, ..., 1], OOB)
    return m2.reshape(lead + (H, W, 2)).astype(np.float32)


def _fraction(coord: torch.Tensor, floor: torch.Tensor, lower: torch.Tensor):
    """The upper tap's weight: the coordinate's offset from the lower tap,
    clipped to [0, n - 2], so that a sample on the last row or column
    (coord = n - 1) reads it at weight 1. The reference takes it from the
    unclipped floor (`orbslam3lib_tpu/utils/rectify.py:199-201`) and reads
    row n - 2 there at full weight (ROADMAP queue 3)."""
    return coord - lower.to(coord.dtype)


def _taps(coord: torch.Tensor, n: int):
    """Per sample along one axis of length n: the lower tap's index (clipped
    to [0, n - 2]) and the weights of the lower and upper taps, zero where
    the coordinate lies outside [0, n - 1]. The validity is taken before
    the clip (the reference's arithmetic, :194-201), the fraction after it
    (`_fraction`)."""
    valid = ((coord >= 0) & (coord <= n - 1)).to(torch.float32)
    c0 = torch.floor(coord)
    idx = torch.clamp(c0.to(torch.int64), 0, n - 2)
    frac = _fraction(coord, c0, idx)
    return idx, (1.0 - frac) * valid, frac * valid


class TwoPassRemap:
    """The per-frame rectification of a stereo pair on its device.

    Built once from the (2, H, W, 2) two-pass maps: the tap indices and
    weights of both passes live on `device`. `__call__` remaps a (2, H, W)
    pair, or a stack of them (..., 2, H, W): acc = w0 * img[y0, x] + w1 * img[y0 + 1, x] at the vertical map,
    then out = w0 * acc[y, x0] + w1 * acc[y, x0 + 1] at the horizontal one,
    each pass two gathers; no value goes back to the host. Out-of-image
    samples are 0 (BORDER_CONSTANT)."""

    def __init__(self, mp2: np.ndarray, device: torch.device | str = "cpu"):
        mp = torch.as_tensor(np.asarray(mp2, np.float32), device=device)
        H, W = mp.shape[-3], mp.shape[-2]
        self.shape = (H, W)
        self.y0, self.wy0, self.wy1 = _taps(mp[..., 1], H)
        self.y1 = self.y0 + 1
        self.x0, self.wx0, self.wx1 = _taps(mp[..., 0], W)
        self.x1 = self.x0 + 1

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        img = img.to(torch.float32)
        lead = img.shape[:-3]

        def taps(x, dim, i0, i1):
            return (torch.gather(x, dim, i0.expand(lead + i0.shape)),
                    torch.gather(x, dim, i1.expand(lead + i1.shape)))
        # addcmul: the second tap fused into the sum, as the reference's
        # compiled accumulation does (1-ulp agreement instead of 2)
        a0, a1 = taps(img, -2, self.y0, self.y1)
        acc = torch.addcmul(self.wy0 * a0, self.wy1, a1)
        b0, b1 = taps(acc, -1, self.x0, self.x1)
        return torch.addcmul(self.wx0 * b0, self.wx1, b1)


def remap_bilinear(img: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """Exact bilinear remap: out[y, x] = img(mp[y, x, 1], mp[y, x, 0])
    (reference :221-251). img (..., H, W); mp (..., H, W, 2) source (x, y)
    coordinates, leading dims broadcast. Out-of-image samples are 0."""
    H, W = img.shape[-2], img.shape[-1]
    mp = torch.broadcast_to(mp, img.shape[:-2] + (H, W, 2))
    x, y = mp[..., 0], mp[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    xi = torch.clamp(x0.to(torch.int64), 0, W - 2)
    yi = torch.clamp(y0.to(torch.int64), 0, H - 2)
    fx, fy = _fraction(x, x0, xi), _fraction(y, y0, yi)
    inb = ((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)).to(img.dtype)
    flat = img.reshape(img.shape[:-2] + (H * W,))

    def sample(yy, xx):
        idx = (yy * W + xx).reshape(img.shape[:-2] + (-1,))
        return torch.gather(flat, -1, idx).reshape(yy.shape)

    p00, p01 = sample(yi, xi), sample(yi, xi + 1)
    p10, p11 = sample(yi + 1, xi), sample(yi + 1, xi + 1)
    top = p00 * (1.0 - fx) + p01 * fx
    bot = p10 * (1.0 - fx) + p11 * fx
    return (top * (1.0 - fy) + bot * fy) * inb
