"""Kernel 1 over a whole pyramid in one launch (`cuda_fast.fast_scores_nms_levels`)
and the arithmetic and tiling of its CUDA source (`csrc/fast_nms.cu`), on the
CPU:

  * the multi-level entry on CPU tensors equals, level by level, the JAX
    Pallas kernel (interpret mode) on the reference's own pyramid of a
    rendered frame: exact, both are f32 min/max/sub;
  * the monotone form of the kernel's arithmetic (min-arc and max-arc
    networks on the raw ring values, then two subtractions) equals
    `fast.fast_scores` bit for bit, on ties, fractional values, values
    equal to the centre and values across many binades;
  * the level table covers every pixel of every level exactly once, and its
    constants are the source's;
  * a numpy transliteration of the kernel's tile (staging with clamped
    reads, the 32x32 score region, the NMS walk) equals the plain version;
  * the kNN kernel's in-kernel bit packing (a carry-free nibble gather).

The CUDA kernels themselves are held against the plain versions on the card
by test_torch_cuda.py and chip_smoke.py.
"""
import re
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.ops import pyramid as jpyr  # noqa: E402
from orbslam3lib_tpu.ops.extractor import DETECT_MARGIN  # noqa: E402
from orbslam3lib_tpu.ops.pallas_fast import fast_scores_nms as j_fast_nms  # noqa: E402
from orbslam3lib_tpu_torch.ops import cuda_fast, fast, pyramid  # noqa: E402

from torch_parity import orbit_frames  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "orbslam3lib_tpu_torch" / "csrc"


@lru_cache(maxsize=None)
def _reference_pyramid():
    """The reference's 8-level pyramid of a rendered 640x400 stereo frame."""
    imgs, _, _ = orbit_frames(1, rig_kw={})
    return [np.array(l) for l in jpyr.build_pyramid(jnp.asarray(imgs[0]), 8)]


@lru_cache(maxsize=None)
def _port_scores():
    levels = [torch.from_numpy(l) for l in _reference_pyramid()]
    cuda_fast.reset_count()
    out = cuda_fast.fast_scores_nms_levels(levels, DETECT_MARGIN)
    assert cuda_fast.launches == 0           # the CPU path launches nothing
    return [o.numpy() for o in out]


@pytest.mark.parametrize("lvl", range(8))
def test_levels_match_pallas_interpret_on_reference_pyramid(lvl):
    level = _reference_pyramid()[lvl]
    got = _port_scores()[lvl]
    assert got.shape == level.shape == (2, jpyr.REF_HEIGHTS[lvl], jpyr.REF_WIDTHS[lvl])
    for eye in range(2):
        want = np.asarray(j_fast_nms(jnp.asarray(level[eye]), margin=DETECT_MARGIN,
                                     interpret=True))
        np.testing.assert_array_equal(got[eye], want)
    if lvl == 0:
        assert got.max() > 0                 # the frame has corners


def test_levels_equal_the_one_level_form():
    rng = np.random.default_rng(5)
    levels = [torch.from_numpy(rng.integers(0, 256, (2, h, w)).astype(np.float32))
              for h, w in [(64, 97), (45, 61), (30, 30)]]
    for got, lvl in zip(cuda_fast.fast_scores_nms_levels(levels, 4), levels):
        assert torch.equal(got, cuda_fast.fast_scores_nms(lvl, 4))


def _monotone_scores(img: torch.Tensor, margin: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: the arc networks on the raw
    ring values, bright = max_k minarc_k - c, dark = c - min_k maxarc_k."""
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1)) for dy, dx in fast.RING])

    def arcs(op, v):
        m = op(v, torch.roll(v, -1, dims=0))
        m = op(m, torch.roll(m, -2, dims=0))
        m = op(m, torch.roll(m, -4, dims=0))
        return op(m, torch.roll(v, -8, dims=0))

    bright = torch.amax(arcs(torch.minimum, ring), dim=0) - img
    dark = img - torch.amin(arcs(torch.maximum, ring), dim=0)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)
    h, w = img.shape[-2:]
    ys, xs = torch.arange(h), torch.arange(w)
    valid = ((ys >= margin) & (ys < h - margin))[:, None] & \
        ((xs >= margin) & (xs < w - margin))[None, :]
    return torch.where(valid, score, torch.zeros_like(score))


def _ring_images(kind: str, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    shape = (2, 48, 64)
    if kind == "integer":            # level 0: integer pixels, ties everywhere
        x = rng.integers(0, 256, shape)
    elif kind == "three_values":     # most ring samples equal the centre
        x = rng.integers(0, 3, shape)
    elif kind == "fractional":
        x = rng.uniform(0, 255, shape)
    elif kind == "binades":          # subtractions that round
        x = rng.uniform(-1, 1, shape) * 10.0 ** rng.integers(-6, 7, shape)
    elif kind == "pyramid":          # a resized level, as the port's pyramid makes it
        img = torch.from_numpy(rng.integers(0, 256, (2, 160, 256)).astype(np.uint8))
        return pyramid.build_pyramid(img, 4)[3]
    else:                            # near-ties: one ulp apart
        base = rng.integers(0, 256, shape).astype(np.float32)
        x = np.nextafter(base, base + rng.integers(-1, 2, shape).astype(np.float32))
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


@pytest.mark.parametrize("kind", ["integer", "three_values", "fractional", "binades",
                                  "pyramid", "ulp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_monotone_arc_form_is_bit_exact(kind, seed):
    img = _ring_images(kind, seed)
    for margin in (3, DETECT_MARGIN):
        want = fast.fast_scores(img, margin=margin)
        got = _monotone_scores(img, margin)
        assert torch.equal(got, want), (kind, margin, (got - want).abs().max())


def _source_constants():
    src = (CSRC / "fast_nms.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    return c["SCORE_W"], c["WARPS"] * c["ROWS_PER_WARP"], c["MAX_LEVELS"]


def test_table_constants_are_the_sources():
    score_w, score_h, max_levels = _source_constants()
    assert (cuda_fast.OUT_W, cuda_fast.OUT_H) == (score_w - 2, score_h - 2)
    assert cuda_fast.MAX_LEVELS == max_levels


def _tile_origin(rows, t):
    """The kernel's tile -> (level, plane, y0, x0) map, as the source does it."""
    l = 0
    while l + 1 < len(rows) and t >= rows[l + 1].first_tile:
        l += 1
    r = rows[l]
    local = t - r.first_tile
    plane, rem = divmod(local, r.tiles_per_plane)
    ty, tx = divmod(rem, r.tiles_x)
    return l, plane, ty * cuda_fast.OUT_H, tx * cuda_fast.OUT_W


LEVEL_SETS = [
    list(zip(jpyr.REF_HEIGHTS, jpyr.REF_WIDTHS)),
    [(37, 203), (13, 5), (1, 1), (62, 30), (63, 31), (124, 61), (125, 161)],
    [(400, 640)],
]


@pytest.mark.parametrize("shapes", LEVEL_SETS)
@pytest.mark.parametrize("batch", [1, 2, 3])
def test_tile_table_covers_every_pixel_once(shapes, batch):
    rows, n_tiles, n_out = cuda_fast.tile_table(shapes, batch)
    count = [np.zeros((batch, h, w), np.int32) for h, w in shapes]
    for t in range(n_tiles):
        l, plane, y0, x0 = _tile_origin(rows, t)
        assert plane < batch
        count[l][plane, y0:y0 + cuda_fast.OUT_H, x0:x0 + cuda_fast.OUT_W] += 1
        # no tile lies wholly outside its level
        assert y0 < shapes[l][0] and x0 < shapes[l][1]
    for c in count:
        assert (c == 1).all()
    # the outputs: one after another, filling the allocation
    end = 0
    for r, (h, w) in zip(rows, shapes):
        assert r.out_off == end
        end = r.out_off + batch * h * w
    assert end == n_out


def _kernel_tile_model(img: np.ndarray, margin: int) -> np.ndarray:
    """A numpy transliteration of fast_nms_levels_kernel over one (H, W)
    plane: per tile the clamped staging, the 64x32 score region with the
    margin check, and the NMS of rows 1..62 and lanes 1..30."""
    h, w = img.shape
    ow, oh = cuda_fast.OUT_W, cuda_fast.OUT_H
    sw, sh = ow + 2, oh + 2
    out = np.full((h, w), np.nan, np.float32)
    rows, n_tiles, _ = cuda_fast.tile_table([(h, w)], 1)
    for t in range(n_tiles):
        _, _, y0, x0 = _tile_origin(rows, t)
        gy = np.clip(np.arange(y0 - 4, y0 - 4 + sh + 6), 0, h - 1)
        gx = np.clip(np.arange(x0 - 4, x0 - 4 + sw + 6), 0, w - 1)
        s_img = torch.from_numpy(img[np.ix_(gy, gx)])
        score = _monotone_scores(s_img, 3)[3:3 + sh, 3:3 + sw].numpy()
        ry = y0 - 1 + np.arange(sh)
        rx = x0 - 1 + np.arange(sw)
        inside = (((ry >= margin) & (ry < h - margin))[:, None]
                  & ((rx >= margin) & (rx < w - margin))[None, :])
        score = np.where(inside, score, np.float32(0))
        win = np.max([score[1 + dy:sh - 1 + dy, 1 + dx:sw - 1 + dx]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)
        c = score[1:-1, 1:-1]
        res = np.where(c >= win, c, np.float32(0))
        ye, xe = min(oh, h - y0), min(ow, w - x0)
        assert np.isnan(out[y0:y0 + ye, x0:x0 + xe]).all()
        out[y0:y0 + ye, x0:x0 + xe] = res[:ye, :xe]
    return out


@pytest.mark.parametrize("h,w,margin", [(127, 203, DETECT_MARGIN), (80, 128, DETECT_MARGIN),
                                        (64, 97, 3), (7, 9, 3)])
def test_kernel_tile_model_matches_plain(h, w, margin):
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w)).astype(np.float32)
    want = cuda_fast.fast_scores_nms_plain(torch.from_numpy(img), margin).numpy()
    np.testing.assert_array_equal(_kernel_tile_model(img, margin), want)


def _nonzero_nibble(w: np.ndarray) -> np.ndarray:
    """csrc/knn2.cu nonzero_nibble on uint32 words (arithmetic mod 2^32)."""
    w = w.astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    t = ((((w & np.uint64(0x7F7F7F7F)) + np.uint64(0x7F7F7F7F)) | w)
         & np.uint64(0x80808080))
    return ((t * np.uint64(0x00204081)) & m32) >> np.uint64(28)


def test_knn_bit_packing_gathers_nonzero_bytes():
    rng = np.random.default_rng(3)
    b = np.concatenate([
        np.array([[(k >> j) & 1 for j in range(4)] for k in range(16)]),     # all 0/1 words
        np.repeat(np.arange(256), 4).reshape(256, 4),                         # every byte value
        rng.integers(0, 256, (4096, 4)),                                      # any byte
        rng.choice([0, 1, 127, 128, 255], (4096, 4)),
    ]).astype(np.uint64)
    words = b[:, 0] | b[:, 1] << np.uint64(8) | b[:, 2] << np.uint64(16) | b[:, 3] << np.uint64(24)
    want = ((b != 0).astype(np.uint64) << np.arange(4, dtype=np.uint64)).sum(axis=1)
    np.testing.assert_array_equal(_nonzero_nibble(words), want)


def test_levels_wrapper_rejects_what_the_kernel_does_not_take():
    lvl = torch.zeros((2, 32, 32))
    with pytest.raises(ValueError):
        cuda_fast.fast_scores_nms_levels([lvl], margin=2)
    with pytest.raises(ValueError):
        cuda_fast.fast_scores_nms_levels([], margin=3)
    with pytest.raises(ValueError):
        cuda_fast.fast_scores_nms_levels([lvl, torch.zeros((1, 16, 16))], margin=3)
    with pytest.raises(ValueError):
        cuda_fast.fast_scores_nms_levels([lvl[0]], margin=3)
    with pytest.raises(ValueError):
        cuda_fast.fast_scores_nms_levels([lvl] * (cuda_fast.MAX_LEVELS + 1), margin=3)
    with pytest.raises(TypeError):
        cuda_fast.fast_scores_nms_levels([lvl.double()], margin=3)


def test_kernel_variant_tool_still_applies_to_the_sources():
    """tools/kernel_variants.py edits the committed sources by text: each of
    its variants must still find what it replaces."""
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "tools" / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    fast_v = kv.fast_variants((CSRC / "fast_nms.cu").read_text())
    knn_v = kv.knn_variants((CSRC / "knn2.cu").read_text())
    assert fast_v["committed"][1] == cuda_fast.OUT_H
    assert len({s for s, _ in fast_v.values()}) == len(fast_v) == 5
    assert len(set(knn_v.values())) == len(knn_v) == 4
