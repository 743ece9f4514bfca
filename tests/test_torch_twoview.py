"""Monocular initialisation's geometry, the port against the JAX reference:
`mapping/twoview.py` (Hartley normalisation, the 8-point F and 4-point H
solvers, their scores, and `reconstruct_two_views` whole) on
tests/test_twoview.py's scenes (general motion with 5% outliers, a planar
scene), and `tracking/matching.match_for_initialization`
(SearchForInitialization) on features with known correspondences; the
reference's samples that repeat a match (a reference fault), which the
port never lets win.

RANSAC runs on the reference's own draws (`jax.random.choice` with its key,
passed in as `hyp_idx`), so the inlier and triangulation masks and counts
are equal. Tolerances: normalised points and transforms within 1e-6
relative; F and H (up to the SVD's sign, scaled to unit norm) within 1e-4
(the null vector of an 8x9 system by another LAPACK call), F within 1e-3
on the planar scene (8 points on a plane leave F's system nearly
rank-deficient, so its null vector is ill-conditioned); scores within
1e-3 relative; the selected R and t within 1e-5, `ratio_H` within 1e-5,
the triangulated points within 1e-4 of their depth (the scenes lie 13-40
baselines away). The matcher's indices and masks are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.mapping import twoview as jtv  # noqa: E402
from orbslam3lib_tpu.tracking import matching as jmt  # noqa: E402
from orbslam3lib_tpu_torch.mapping import twoview as ttv  # noqa: E402
from orbslam3lib_tpu_torch.tracking import matching as tmt  # noqa: E402

from torch_parity import reference_draws  # noqa: E402

CAM = np.array([300.0, 300.0, 320.0, 200.0], np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def _pair(planar: bool, seed: int = 91, n: int = 300, outlier_frac: float = 0.05):
    """tests/test_twoview.py's make_pair in numpy: points 4-12 m ahead (or
    on the plane z = 6), camera 2 moved 0.3 m along x and turned 0.05 rad
    about y, 0.3 px of noise, outliers pushed 20-80 px."""
    rng = np.random.default_rng(seed)
    if planar:
        p = rng.uniform([-3, -2, 6], [3, 2, 6.01], size=(n, 3)).astype(np.float32)
    else:
        p = rng.uniform([-3, -2, 4], [3, 2, 12], size=(n, 3)).astype(np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    R21 = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t21 = np.array([-0.3, 0.0, 0.0], np.float32)
    p2 = p @ R21.T + t21

    def proj(q):
        return np.stack([CAM[0] * q[:, 0] / q[:, 2] + CAM[2],
                         CAM[1] * q[:, 1] / q[:, 2] + CAM[3]], 1).astype(np.float32)
    uv1 = proj(p) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    uv2 = proj(p2) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    n_out = int(n * outlier_frac)
    uv2[:n_out] += rng.uniform(20, 80, (n_out, 2)).astype(np.float32)
    valid = ((uv1 > 0) & (uv1 < [640, 400])).all(1) & ((uv2 > 0) & (uv2 < [640, 400])).all(1)
    return uv1, uv2, valid


SCENES = {"general": dict(planar=False), "planar": dict(planar=True, outlier_frac=0.0)}
F_RTOL = {"general": 1e-4, "planar": 1e-3}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return _pair(**SCENES[request.param]) + (request.param,)


def _rel(a, b, rtol, msg=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-30),
                               err_msg=msg)


def _unit_up_to_sign(M):
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M, axis=(-2, -1), keepdims=True)
    k = np.abs(M.reshape(M.shape[:-2] + (9,))).argmax(-1)
    sign = np.sign(np.take_along_axis(M.reshape(M.shape[:-2] + (9,)), k[..., None], -1))
    return M * sign[..., None]


def test_helpers_agree(scene):
    """_normalize over all rows, the batched 8-point F and 4-point H of the
    reference's draws, and both scores with their inlier masks."""
    uv1, uv2, valid, name = scene
    n1j, T1j = jtv._normalize(jnp.asarray(uv1))
    n1t, T1t = ttv._normalize(t(uv1))
    _rel(n1t.numpy(), n1j, 1e-6)
    _rel(T1t.numpy(), T1j, 1e-6)
    n2j, _ = jtv._normalize(jnp.asarray(uv2))
    n2t, _ = ttv._normalize(t(uv2))
    idx = reference_draws(valid, 200, 8)[:16]
    Fj = np.stack([np.asarray(jtv._eight_point_F(n1j[i], n2j[i])) for i in idx])
    Ft = ttv._eight_point_F(n1t[t(idx).long()], n2t[t(idx).long()]).numpy()
    _rel(_unit_up_to_sign(Ft), _unit_up_to_sign(Fj), F_RTOL[name], "F")
    Hj = np.stack([np.asarray(jtv._four_point_H(n1j[i[:4]], n2j[i[:4]])) for i in idx])
    Ht = ttv._four_point_H(n1t[t(idx[:, :4]).long()], n2t[t(idx[:, :4]).long()]).numpy()
    _rel(_unit_up_to_sign(Ht), _unit_up_to_sign(Hj), 1e-4, "H")
    for k in range(4):
        sj, inj = jtv._score_F(jnp.asarray(Fj[k]), jnp.asarray(uv1), jnp.asarray(uv2),
                               jnp.asarray(valid))
        st, int_ = ttv._score_F(t(Fj[k]), t(uv1), t(uv2), t(valid))
        _rel(st.numpy(), sj, 1e-3, "score F")
        np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
        sj, inj = jtv._score_H(jnp.asarray(Hj[k]), jnp.asarray(uv1), jnp.asarray(uv2),
                               jnp.asarray(valid))
        st, int_ = ttv._score_H(t(Hj[k]), t(uv1), t(uv2), t(valid))
        _rel(st.numpy(), sj, 1e-3, "score H")
        np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))


def test_reconstruct_two_views_agrees(scene):
    """The whole reconstruction on the reference's draws: the verdict, the
    good-point count and mask equal; the selected (R, t), `ratio_H` and the
    triangulated points to tolerance (never the candidate's index: the
    SVDs' signs order the four candidates). The planar scene fails the
    acceptance rule in both (F is the reference's only model)."""
    uv1, uv2, valid, name = scene
    want = {k: np.asarray(v) for k, v in jtv.reconstruct_two_views(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), jnp.asarray(CAM)).items()}
    got = {k: v.numpy() for k, v in ttv.reconstruct_two_views(
        t(uv1), t(uv2), t(valid), t(CAM), hyp_idx=reference_draws(valid, 200, 8)).items()}
    assert bool(got["success"]) == bool(want["success"]) == (name == "general")
    assert int(got["n_good"]) == int(want["n_good"])
    assert (int(want["n_good"]) > 200) == (name == "general")
    np.testing.assert_array_equal(got["tri_ok"], want["tri_ok"])
    np.testing.assert_allclose(got["ratio_H"], want["ratio_H"], rtol=0, atol=1e-5)
    if name == "planar":
        return      # no motion to compare: F's null vector is ill-conditioned
    np.testing.assert_allclose(got["R"], want["R"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["t"], want["t"], rtol=0, atol=1e-5)
    ok = want["tri_ok"]
    err = np.abs(got["p3d"][ok] - want["p3d"][ok]).max(axis=1) / want["p3d"][ok, 2]
    assert err.max() < 1e-4, err.max()


def test_reconstruct_rejects_a_pure_rotation():
    """No baseline: the parallax gate refuses in both packages."""
    rng = np.random.default_rng(4)
    uv1 = rng.uniform([50, 50], [590, 350], size=(300, 2)).astype(np.float32)
    valid = np.ones(300, bool)
    draws = reference_draws(valid, 200, 8)
    want = jtv.reconstruct_two_views(jnp.asarray(uv1), jnp.asarray(uv1 + 0.01),
                                     jnp.asarray(valid), jnp.asarray(CAM))
    got = ttv.reconstruct_two_views(t(uv1), t(uv1 + 0.01), t(valid), t(CAM), hyp_idx=draws)
    assert bool(got["success"]) == bool(want["success"]) is False


def test_reference_repeated_draws_fault():
    """Reference fault (ROADMAP queue 3): the reference draws each
    hypothesis' 8 matches with replacement (`jax.random.choice`,
    twoview.py:120), so some samples repeat a match. Such a sample's 8x9
    system has rank 7, and the F the reference's SVD returns for it is set
    by rounding: moving the sample's points by 1e-6 of themselves turns
    its unit F by more than 1e-2, a sample of 8 distinct matches' by less
    than 1e-3."""
    uv1, uv2, valid = _pair(False)
    draws = reference_draws(valid, 200, 8)
    repeated = np.array([len(set(row)) < 8 for row in draws])
    assert repeated.sum() >= 5
    n1, _ = jtv._normalize(jnp.asarray(uv1))
    n2 = np.asarray(jtv._normalize(jnp.asarray(uv2))[0])
    n1 = np.asarray(n1)
    rng = np.random.default_rng(0)
    turn = []
    for row in draws:
        a, b = n1[row], n2[row]
        nudged = (a * (1.0 + 1e-6 * rng.standard_normal(a.shape))).astype(np.float32)
        F, F_nudged = (_unit_up_to_sign(jtv._eight_point_F(jnp.asarray(x), jnp.asarray(b)))
                       for x in (a, nudged))
        turn.append(np.abs(F - F_nudged).max())
    turn = np.array(turn)
    assert turn[repeated].min() > 1e-2, turn[repeated].min()
    assert turn[~repeated].max() < 1e-3, turn[~repeated].max()


def test_repeated_samples_never_win():
    """The port's side of that fault: a sample that repeats a match never
    makes the best F. On the general scene, the reference's repeated
    samples (199 rows) beside one distinct sample that scores below the
    best of them give the reconstruction of the distinct sample alone (200
    copies of it): the same verdict, R, t, good-point count and mask."""
    uv1, uv2, valid = _pair(False)
    draws = reference_draws(valid, 200, 8)
    repeated = np.array([len(set(row)) < 8 for row in draws])
    n1, T1 = ttv._normalize(t(uv1))
    n2, T2 = ttv._normalize(t(uv2))
    idx = t(draws).long()
    F = T2.T @ ttv._eight_point_F(n1[idx], n2[idx]) @ T1
    F = ttv._scale_by(F, torch.clamp(torch.abs(F[:, 2, 2]), min=1e-12))
    score = ttv._score_F(F, t(uv1), t(uv2), t(valid))[0].numpy()
    top_repeated = score[repeated].max()
    below = np.flatnonzero(~repeated & (score < top_repeated))
    d = below[np.argmax(score[below])]
    mixed = np.concatenate([np.resize(draws[repeated], (199, 8)), draws[d][None]])
    alone = np.repeat(draws[d][None], 200, axis=0)
    got, want = (ttv.reconstruct_two_views(t(uv1), t(uv2), t(valid), t(CAM), hyp_idx=h)
                 for h in (mixed, alone))
    assert bool(got["success"]) == bool(want["success"]) is True
    assert int(got["n_good"]) == int(want["n_good"])
    for k in ("R", "t", "tri_ok"):
        assert torch.equal(got[k], want[k]), k


def _features(seed: int, n: int = 256):
    """Frame a and b: b holds a's features moved by up to 40 px (some 150
    px, outside the window), shuffled, with 0-12 of 256 bits flipped and
    the angle turned by 0.1 rad (a few by 2 rad: the rotation histogram's
    outliers); 10% of a's slots invalid, 10% of b's features unrelated."""
    rng = np.random.default_rng(seed)
    xy_a = rng.uniform([0, 0], [640, 400], size=(n, 2)).astype(np.float32)
    desc_a = rng.integers(0, 2, size=(n, 256)).astype(np.int8)
    ang_a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    valid_a = rng.uniform(size=n) > 0.1
    perm = rng.permutation(n)
    shift = rng.uniform(-40, 40, size=(n, 2)).astype(np.float32)
    shift[rng.uniform(size=n) < 0.1] = 150.0
    xy_b = (xy_a + shift)[perm]
    flips = (rng.uniform(size=(n, 256)) < rng.uniform(0, 12 / 256, size=(n, 1)))
    desc_b = (desc_a ^ flips.astype(np.int8))[perm]
    ang_b = np.mod(ang_a + 0.1 + 2.0 * (rng.uniform(size=n) < 0.05), 2 * np.pi)
    ang_b = ang_b.astype(np.float32)[perm]
    junk = rng.uniform(size=n) < 0.1
    desc_b[junk] = rng.integers(0, 2, size=(int(junk.sum()), 256))
    valid_b = np.ones(n, bool)
    return xy_a, desc_a, valid_a, ang_a, xy_b, desc_b, valid_b, ang_b


@pytest.mark.parametrize("seed,window,th,ratio", [(0, 100.0, 50.0, 0.9), (1, 100.0, 50.0, 0.9),
                                                  (2, 60.0, 40.0, 0.7)])
def test_match_for_initialization_agrees(seed, window, th, ratio):
    """Indices and the mask equal, on features where the window, the
    threshold, the ratio and the rotation histogram each reject some."""
    arrs = _features(seed)
    j_idx, j_ok = jmt.match_for_initialization(*(jnp.asarray(a) for a in arrs),
                                               window=window, th=th, ratio=ratio)
    t_idx, t_ok = tmt.match_for_initialization(*(t(a) for a in arrs),
                                               window=window, th=th, ratio=ratio)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert t_idx.dtype == torch.int32
    assert 100 < int(j_ok.sum()) < int(arrs[2].sum())
