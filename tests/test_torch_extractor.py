"""ORB extraction of the port against the JAX reference: the pyramid, and
`extract_orb_stereo` end to end (FAST+NMS, tile and global top-K,
orientation, rotated BRIEF), on the same rendered stereo pair; and
`extract_orb_mono` (one image, the monocular and RGB-D frame)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.ops import extractor as jex, orient_brief as job  # noqa: E402
from orbslam3lib_tpu.ops import pyramid as jpyr  # noqa: E402
from orbslam3lib_tpu_torch.ops import extractor as tex, pyramid as tpyr  # noqa: E402

from torch_parity import (fast_reference_brief, orbit_frames,  # noqa: E402,F401
                          reference_compare_blur_matrices)


def test_reference_brief_table_shortcut():
    """The tests' fast build of the reference's fused blur+compare table
    equals the reference's own einsum, on two angle bins' rows."""
    D = job._compare_matrices().astype(np.float64)
    B = job._blur_matrix().astype(np.float64)
    fast = reference_compare_blur_matrices()
    for a in (0, 21):
        Dm = D[a].reshape(256, job.BRIEF_PATCH, job.BRIEF_PATCH)
        want = np.einsum("bil,ij,lk->bjk", Dm, B, B).reshape(256, -1).astype(np.float32)
        np.testing.assert_array_equal(fast[a * 256:(a + 1) * 256, :job.RAW_FLAT], want)


@pytest.mark.parametrize("h,w,n_levels", [(400, 640, 8), (200, 320, 4)])
def test_pyramid_levels_agree(h, w, n_levels):
    """Same host-built resize matrices, f32 products on both sides; the
    summation order differs, so levels >= 1 agree to 1e-4 grey levels
    (observed ~1.5e-5), not bitwise. Shapes and scales are equal."""
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (2, h, w)).astype(np.uint8)
    want = jpyr.build_pyramid(jnp.asarray(img), n_levels)
    got = tpyr.build_pyramid(torch.from_numpy(img), n_levels)
    assert tpyr.level_shapes(h, w, n_levels) == jpyr.level_shapes(h, w, n_levels)
    np.testing.assert_array_equal(tpyr.scale_factors(n_levels), jpyr.scale_factors(n_levels))
    for g, wl in zip(got, want):
        assert g.shape == wl.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wl), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def both_extractions(fast_reference_brief):
    imgs, _, _ = orbit_frames(2)
    img = imgs[1]
    fj, cj = jex.extract_orb_stereo(jnp.asarray(img), jnp.float32(12.0), max_kp=256,
                                    n_levels=4, return_canvas=True)
    ft, ct = tex.extract_orb_stereo(torch.from_numpy(img), 12.0, max_kp=256,
                                    n_levels=4, return_canvas=True)
    return fj, cj, ft, ct


def _keyed(level, xy, valid):
    return {(int(l), float(x), float(y)): i
            for i, (l, (x, y), v) in enumerate(zip(level, xy, valid)) if v}


def test_extractor_fields_and_dtypes(both_extractions):
    fj, cj, ft, ct = both_extractions
    for name in ("xy", "level", "score", "angle", "desc", "valid"):
        g, w = getattr(ft, name), np.asarray(getattr(fj, name))
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
    assert tuple(ct.shape) == cj.shape
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-4)


@pytest.mark.parametrize("eye", [0, 1])
def test_extractor_keypoints_agree(both_extractions, eye):
    """Level-0 keypoints are equal as sets (integer pixels: bit-exact FAST
    and the same stable top-K); upper levels see the ~1e-5 pyramid rounding
    difference, so the whole sets must overlap by >= 98% (observed 100%).
    On shared keypoints, angles agree to 1e-4 rad (f32 moment sums in
    another order) and descriptor bits agree on >= 99.9% (a bit may flip
    only where its bf16 compare sum sits at accumulation noise). FAST scores
    of shared keypoints are equal on level 0 and within 1e-4 above."""
    fj, _, ft, _ = both_extractions
    kj = _keyed(np.asarray(fj.level[eye]), np.asarray(fj.xy[eye]), np.asarray(fj.valid[eye]))
    kt = _keyed(ft.level[eye].numpy(), ft.xy[eye].numpy(), ft.valid[eye].numpy())
    assert len(kj) > 100
    assert {k for k in kj if k[0] == 0} == {k for k in kt if k[0] == 0}
    common = sorted(set(kj) & set(kt))
    assert len(common) >= 0.98 * max(len(kj), len(kt))
    ij = np.array([kj[k] for k in common])
    it = np.array([kt[k] for k in common])
    np.testing.assert_allclose(ft.angle[eye].numpy()[it], np.asarray(fj.angle[eye])[ij],
                               rtol=0, atol=1e-4)
    # FAST scores: exact on level 0, pyramid rounding (1e-4) above
    np.testing.assert_allclose(ft.score[eye].numpy()[it], np.asarray(fj.score[eye])[ij],
                               rtol=0, atol=1e-4)
    lvl0 = np.array([k[0] == 0 for k in common])
    np.testing.assert_array_equal(ft.score[eye].numpy()[it[lvl0]],
                                  np.asarray(fj.score[eye])[ij[lvl0]])
    agree = (ft.desc[eye].numpy()[it] == np.asarray(fj.desc[eye])[ij]).mean()
    assert agree >= 0.999, agree


def test_extract_orb_mono(fast_reference_brief):
    """One image: the stereo extractor's graph on a batch of one (its
    fields equal the left eye's of `extract_orb_stereo` on that image
    alone), with the reference's leading eye axis of 1, dtypes, and level-0
    keypoints equal as sets."""
    imgs, _, _ = orbit_frames(2)
    img = imgs[1][0]
    ft = tex.extract_orb_mono(torch.from_numpy(img), 12.0, max_kp=256, n_levels=4)
    fs = tex.extract_orb_stereo(torch.from_numpy(img[None]), 12.0, max_kp=256, n_levels=4)
    fj = jex.extract_orb_mono(jnp.asarray(img), jnp.float32(12.0), max_kp=256, n_levels=4)
    for name in ("xy", "level", "score", "angle", "desc", "valid"):
        g, w = getattr(ft, name), np.asarray(getattr(fj, name))
        assert tuple(g.shape) == w.shape and g.shape[0] == 1, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        assert torch.equal(g, getattr(fs, name)), name
    kj = _keyed(np.asarray(fj.level[0]), np.asarray(fj.xy[0]), np.asarray(fj.valid[0]))
    kt = _keyed(ft.level[0].numpy(), ft.xy[0].numpy(), ft.valid[0].numpy())
    assert len(kj) > 100
    assert {k for k in kj if k[0] == 0} == {k for k in kt if k[0] == 0}


def test_threshold_controller_is_the_reference_one():
    j, t = jex.ThresholdController(200, 30, 17.0), tex.ThresholdController(200, 30, 17.0)
    for n in (512, 512, 40, 180, 260, 90, 512, 10):
        assert t.update(n) == j.update(n)
