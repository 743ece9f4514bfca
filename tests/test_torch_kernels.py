"""The plain versions of the port's two kernels (their CPU path and their
oracle on the card) against the JAX reference, bit for bit:

  * FAST-9/16 + 3x3 NMS: `cuda_fast.fast_scores_nms` on a CPU tensor vs
    the reference's `fast.nms3x3(fast.fast_scores(.))` and its Pallas kernel
    in interpret mode;
  * Hamming kNN-2: `cuda_matcher.knn_match_fused` on CPU tensors vs the
    reference's `matcher.knn_match` and its Pallas kernel in interpret mode.

Both are exact computations (f32 min/max/sub; integer popcounts), so no
tolerance. Also the wrappers' input checks on the CPU; the CUDA kernels
themselves are held against these plain versions on the card by
test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.ops import fast as jfast  # noqa: E402
from orbslam3lib_tpu.ops import pyramid as jpyr  # noqa: E402
from orbslam3lib_tpu.ops.extractor import DETECT_MARGIN  # noqa: E402
from orbslam3lib_tpu.ops.matcher import knn_match as j_knn  # noqa: E402
from orbslam3lib_tpu.ops.matcher import mutual_best as j_mutual_best  # noqa: E402
from orbslam3lib_tpu.ops.pallas_fast import fast_scores_nms as j_fast_nms  # noqa: E402
from orbslam3lib_tpu.ops.pallas_matcher import knn_match_fused as j_knn_fused  # noqa: E402
from orbslam3lib_tpu_torch.ops import cuda_fast, cuda_matcher, matcher  # noqa: E402

from torch_parity import orbit_frames  # noqa: E402


def _j_fast(img, margin):
    return np.asarray(jfast.nms3x3(jfast.fast_scores(jnp.asarray(img), margin=margin)))


# the reference's Pallas-kernel cases (tests/test_pallas_ops.py) ...
PALLAS_CASES = [(400, 640, 21), (80, 128, 21), (100, 161, 21), (64, 128, 3)]
# ... and every reference pyramid level at the extractor's margin
LEVEL_CASES = [(h, w, DETECT_MARGIN) for h, w in zip(jpyr.REF_HEIGHTS, jpyr.REF_WIDTHS)]


@pytest.mark.parametrize("h,w,margin", PALLAS_CASES + LEVEL_CASES)
def test_fast_plain_bit_exact_random(h, w, margin):
    rng = np.random.default_rng(h * 7 + w)
    img = rng.integers(0, 256, (h, w)).astype(np.float32)
    got = cuda_fast.fast_scores_nms(torch.from_numpy(img), margin).numpy()
    np.testing.assert_array_equal(got, _j_fast(img, margin))
    # uint8 input is accepted as is
    got_u8 = cuda_fast.fast_scores_nms(torch.from_numpy(img.astype(np.uint8)), margin)
    np.testing.assert_array_equal(got_u8.numpy(), got)


def test_fast_plain_bit_exact_vs_pallas_interpret():
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 255, (100, 161)).astype(np.float32)
    want = np.asarray(j_fast_nms(jnp.asarray(img), margin=21, interpret=True))
    got = cuda_fast.fast_scores_nms(torch.from_numpy(img), 21).numpy()
    np.testing.assert_array_equal(got, want)


def test_fast_plain_bit_exact_rendered_levels():
    """Rendered orbit frames at level 0 (integer pixels) and level 3 (the
    reference's resize output), both eyes as one batch, like the extractor
    calls it."""
    imgs, _, _ = orbit_frames(1, rig_kw={})
    levels = jpyr.build_pyramid(jnp.asarray(imgs[0]), 4)
    for lvl in (levels[0], levels[3]):
        lvl = np.array(lvl)
        got = cuda_fast.fast_scores_nms(torch.from_numpy(lvl), DETECT_MARGIN).numpy()
        for eye in range(2):
            np.testing.assert_array_equal(got[eye], _j_fast(lvl[eye], DETECT_MARGIN))


def _bits(rng, na, nb, masked):
    a = (rng.random((na, 256)) < 0.5).astype(np.int8)
    b = (rng.random((nb, 256)) < 0.5).astype(np.int8)
    av = rng.random(na) < 0.9 if masked else None
    bv = rng.random(nb) < 0.9 if masked else None
    return a, b, av, bv


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("na,nb,masked", [(64, 64, True), (300, 450, True),
                                          (512, 1024, True), (100, 200, False),
                                          (512, 512, True), (1, 1, True),
                                          (33, 3000, True), (5, 16500, True)])
def test_knn_plain_bit_exact(na, nb, masked):
    rng = np.random.default_rng(na * 1000 + nb)
    a, b, av, bv = _bits(rng, na, nb, masked)
    got = cuda_matcher.knn_match_fused(_t(a), _t(b), _t(av), _t(bv))
    want = j_knn(_j(a), _j(b), _j(av), _j(bv))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("na,nb", [(64, 64), (300, 450)])
def test_knn_plain_bit_exact_vs_pallas_interpret(na, nb):
    rng = np.random.default_rng(na + nb)
    a, b, av, bv = _bits(rng, na, nb, True)
    got = cuda_matcher.knn_match_fused(_t(a), _t(b), _t(av), _t(bv))
    want = j_knn_fused(_j(a), _j(b), _j(av), _j(bv), interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_knn_ties_go_to_lowest_column():
    a = torch.zeros((3, 256), dtype=torch.int8)
    b = torch.zeros((4, 256), dtype=torch.int8)
    b[0, :5] = 1                        # distance 5 from a zero row
    b[1, :2] = 1                        # 2
    b[3, 100:102] = 1                   # 2 (tie with column 1)
    best, d1, d2 = cuda_matcher.knn_match_fused(a, b)
    assert best.tolist() == [2, 2, 2] and d1.tolist() == [0.0] * 3
    assert d2.tolist() == [2.0] * 3
    best, d1, d2 = cuda_matcher.knn_match_fused(a, b, b_valid=torch.tensor([1, 1, 0, 1]).bool())
    assert best.tolist() == [1, 1, 1] and d2.tolist() == [2.0] * 3
    # a lone column: d2 is d1 + BIG, as in the reference
    best, d1, d2 = cuda_matcher.knn_match_fused(a, b[:1], a_valid=torch.tensor([1, 0, 1]).bool())
    assert d1.tolist() == [5.0, 4101.0, 5.0] and d2.tolist() == [4101.0, 8197.0, 4101.0]


def test_wrappers_reject_what_the_kernels_do_not_take():
    img = torch.zeros((64, 64))
    with pytest.raises(ValueError):
        cuda_fast.fast_scores_nms(img, margin=2)
    with pytest.raises(TypeError):
        cuda_fast.fast_scores_nms(img.double(), margin=3)
    with pytest.raises(ValueError):
        cuda_fast.fast_scores_nms(img[None, None], margin=3)
    bits = torch.zeros((4, 256), dtype=torch.int8)
    with pytest.raises(TypeError):
        cuda_matcher.knn_match_fused(bits.float(), bits)
    with pytest.raises(ValueError):
        cuda_matcher.knn_match_fused(bits[:, :128], bits)
    with pytest.raises(ValueError):
        cuda_matcher.knn_match_fused(bits[:0], bits)


def test_cpu_path_launches_no_kernel():
    cuda_fast.reset_count()
    cuda_matcher.reset_count()
    cuda_fast.fast_scores_nms(torch.zeros((32, 32)), 3)
    cuda_fast.fast_scores_nms_levels([torch.zeros((2, 32, 32)), torch.zeros((2, 16, 24))], 3)
    bits = torch.zeros((4, 256), dtype=torch.int8)
    cuda_matcher.knn_match_fused(bits, bits)
    assert cuda_fast.launches == 0 and cuda_matcher.launches == 0


def test_mutual_best_agrees():
    """Mutual nearest neighbours on Hamming distances with ties (256-bit
    descriptors of few distinct values): the same best columns, the lowest
    on ties, and the same agreement flags as the reference's."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2, (96, 256)).astype(np.int8)
    b = np.concatenate([a[rng.permutation(96)[:40]], rng.integers(0, 2, (50, 256))]).astype(np.int8)
    b[45:50] = b[40]                               # tied columns
    d = matcher.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b))
    best_t, agree_t = matcher.mutual_best(d)
    best_j, agree_j = j_mutual_best(jnp.asarray(d.numpy()))
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(agree_t.numpy(), np.asarray(agree_j))
    assert int(agree_t.sum()) >= 40
