"""Fused FAST-9/16 score + 3x3 NMS: the wrapper of kernel 1
(`csrc/fast_nms.cu`), the port of `orbslam3lib_tpu/ops/pallas_fast.py`.

`fast_scores_nms_levels` runs every level of a pyramid (both eyes) in one
launch; `fast_scores_nms` is the one-level form, on the same kernel with a
one-entry level table. On CPU tensors both return the plain version,
`fast.nms3x3(fast.fast_scores(level, margin))` per level; on CUDA tensors
they launch the kernel or raise. The two agree bit for bit (see the
source's note).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from . import _cuda_lib, fast

launches = 0   # kernel launches made by this process (see chip_smoke.py)

# The kernel's tiling (csrc/fast_nms.cu: OUT_W, OUT_H, MAX_LEVELS): a block
# writes one OUT_W x OUT_H output tile of one image plane of one level.
OUT_W, OUT_H = 30, 30
MAX_LEVELS = 16


class LevelTiles(NamedTuple):
    """One level's row of the kernel's table (offsets in f32 elements)."""
    out_off: int
    h: int
    w: int
    tiles_x: int
    tiles_per_plane: int
    first_tile: int


def reset_count() -> None:
    global launches
    launches = 0


def tile_table(shapes: Sequence[Tuple[int, int]], batch: int):
    """The flat tile grid over levels of (batch, H, W): one row per level
    and the totals (tiles, f32 elements of the flat output). Tile t of
    level l, t - first_tile = (plane * tiles_y + ty) * tiles_x + tx, writes
    rows [ty*OUT_H, +OUT_H) and columns [tx*OUT_W, +OUT_W) of that plane,
    clipped to the level."""
    rows, first, off = [], 0, 0
    for h, w in shapes:
        tiles_x = -(-w // OUT_W)
        per_plane = tiles_x * -(-h // OUT_H)
        rows.append(LevelTiles(off, h, w, tiles_x, per_plane, first))
        first += batch * per_plane
        off += batch * h * w
    return rows, first, off


def fast_scores_nms_plain(img: torch.Tensor, margin: int) -> torch.Tensor:
    return fast.nms3x3(fast.fast_scores(img.to(torch.float32), margin=margin))


def fast_scores_nms_levels_plain(levels: Sequence[torch.Tensor],
                                 margin: int) -> List[torch.Tensor]:
    return [fast_scores_nms_plain(lvl, margin) for lvl in levels]


def _check_margin(margin: int) -> None:
    if margin < 3:
        raise ValueError(f"margin must be >= 3 (the FAST ring radius), got {margin}")


def _check_dtype(img: torch.Tensor) -> None:
    if img.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"expected float32 or uint8, got {img.dtype}")


def prepare_launch(levels: List[torch.Tensor], margin: int):
    """(outputs, launch) for (batch, H, W) contiguous f32 CUDA levels:
    `launch()` runs the kernel once on the current stream, writing the
    (batch, H_l, W_l) output views, and counts the launch. The wrappers call
    it once; a timing loop may call it many times on the same buffers."""
    batch, dev = levels[0].shape[0], levels[0].device
    rows, n_tiles, n_out = tile_table([tuple(l.shape[1:]) for l in levels], batch)
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    table = (ctypes.c_longlong * (7 * len(rows) + 1))(
        *[v for lvl, r in zip(levels, rows) for v in (lvl.data_ptr(), *r)], n_tiles)
    lib = _cuda_lib.library()
    views = [out[r.out_off:r.out_off + batch * r.h * r.w].view(batch, r.h, r.w)
             for r in rows]

    def launch() -> None:
        global launches
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fast_nms_levels_launch(ctypes.addressof(table), len(rows),
                                             out.data_ptr(), margin, stream)
        _cuda_lib.check(err, "fast_nms_levels_launch")
        launches += 1

    return views, launch


def _launch(levels: List[torch.Tensor], margin: int) -> List[torch.Tensor]:
    views, launch = prepare_launch(levels, margin)
    launch()
    return views


def fast_scores_nms_levels(levels: Sequence[torch.Tensor],
                           margin: int) -> List[torch.Tensor]:
    """NMS'd exact FAST-9/16 score maps of the levels of a pyramid, each
    (B, H_l, W_l) f32/uint8 with one B: a list of (B, H_l, W_l) f32 maps,
    score kept only at 3x3 local maxima, margin rows/columns zeroed. On the
    card: one launch, and the maps are views into one allocation."""
    _check_margin(margin)
    levels = list(levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"expected 1 to {MAX_LEVELS} levels, got {len(levels)}")
    for lvl in levels:
        if lvl.dim() != 3 or lvl.shape[0] != levels[0].shape[0]:
            raise ValueError("expected (B, H, W) levels with one B, got shapes "
                             f"{[tuple(l.shape) for l in levels]}")
        if lvl.device != levels[0].device:
            raise ValueError(f"levels on {lvl.device} and {levels[0].device}")
        _check_dtype(lvl)
    dev = levels[0].device
    if dev.type == "cpu":
        return fast_scores_nms_levels_plain(levels, margin)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch([l.to(torch.float32).contiguous() for l in levels], margin)


def fast_scores_nms(img: torch.Tensor, margin: int = 3) -> torch.Tensor:
    """NMS'd exact FAST-9/16 score map of (H, W) or (B, H, W) f32/uint8
    images: (..., H, W) f32, score kept only at 3x3 local maxima, margin
    rows/columns zeroed. `margin` must be >= 3 (the ring radius)."""
    _check_margin(margin)
    if img.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got shape {tuple(img.shape)}")
    _check_dtype(img)
    if img.device.type == "cpu":
        return fast_scores_nms_plain(img, margin)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    x = img.to(torch.float32).contiguous()
    return _launch([x.view((-1,) + x.shape[-2:])], margin)[0].view(x.shape)
