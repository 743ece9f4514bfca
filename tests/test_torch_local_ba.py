"""Local BA and its math of the port against the JAX reference: the
closed-form small-matrix solves (`utils/smallmat.py`), the midpoint
triangulation (`utils/cameras.triangulate_two_view`) and the Schur-complement
LM (`mapping/local_ba.bundle_adjust`), on the cases of the reference's own
tests (`tests/test_smallmat.py`, `tests/test_local_ba.py`).

Tolerances:
- inv3, adjugate4, smallest_eigvec4_psd: 1e-5 relative to (1 + |x|): the
  same f32 formulas, evaluated in another order only where XLA fuses;
- triangulate_two_view: 1e-5 relative to (1 + |x|) on the points, 1e-6 on
  the cosine and depths (the same f32 formulas; einsum and cross product
  sum three terms in another order);
- bundle_adjust: poses and points within 1e-4, inlier masks equal: ten LM
  iterations of f32 normal equations scattered (index_add_ vs
  segment_sum) and contracted (einsum) in another order.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.mapping import local_ba as jba  # noqa: E402
from orbslam3lib_tpu.utils import cameras as jcam, smallmat as jsm  # noqa: E402
from orbslam3lib_tpu_torch.mapping import local_ba as tba  # noqa: E402
from orbslam3lib_tpu_torch.utils import cameras as tcam, smallmat as tsm  # noqa: E402

from test_local_ba import CAM, make_ba_problem  # noqa: E402


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rel * (1.0 + np.abs(want))), \
        np.max(np.abs(got - want) / (1.0 + np.abs(want)))


def _inv3_case():
    A = np.random.default_rng(0).normal(0, 1, (512, 3, 3)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + 2.0 * np.eye(3, dtype=np.float32)


def _psd4_case():
    B = np.random.default_rng(2).normal(0, 1, (256, 4, 4)).astype(np.float64)
    M = B @ B.transpose(0, 2, 1)
    w, _ = np.linalg.eigh(M)
    return (M - (w[:, 0, None, None] * 0.999) * np.eye(4)).astype(np.float32)


@pytest.mark.parametrize("name", ["inv3", "adjugate4", "smallest_eigvec4_psd"])
def test_smallmat(name):
    x = {"inv3": _inv3_case,
         "adjugate4": lambda: np.random.default_rng(1).normal(
             0, 1, (256, 4, 4)).astype(np.float32),
         "smallest_eigvec4_psd": _psd4_case}[name]()
    got = getattr(tsm, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jsm, name)(jnp.asarray(x)))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("baseline", [0.5, 0.05, 0.026])
def test_triangulate_two_view(baseline):
    """The small-parallax case of test_smallmat.py: centimetre baselines
    against points metres away, where the denominator is tiny."""
    rng = np.random.default_rng(3)
    F = 512
    pts = rng.uniform([-3, -1.5, 2.5], [3, 1.5, 8], (F, 3))
    t2 = np.array([-baseline, 0.0, 0.0])
    ray1 = (pts / pts[:, 2:3]).astype(np.float32)
    p_c2 = pts + t2
    ray2 = (p_c2 / p_c2[:, 2:3]).astype(np.float32)
    R12 = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
    t12 = np.tile((-t2).astype(np.float32), (F, 1))
    got = tcam.triangulate_two_view(*(torch.from_numpy(a) for a in (ray1, ray2, R12, t12)))
    want = jcam.triangulate_two_view(*(jnp.asarray(a) for a in (ray1, ray2, R12, t12)))
    _close(got[0].numpy(), want[0], 1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def _to_torch(prob):
    return tba.BAProblem(*(torch.from_numpy(np.array(x)) for x in prob))


@pytest.mark.parametrize("outlier_frac", [0.0, 0.1])
def test_bundle_adjust(outlier_frac):
    """Six cameras (two fixed) and 200 points; with 10% outliers the chi2
    gate after iteration 5 drops edges, and the masks must agree."""
    prob, _ = make_ba_problem(outlier_frac=outlier_frac)
    R_j, t_j, p_j, inl_j = jba.bundle_adjust(prob, CAM)
    R_t, t_t, p_t, inl_t = tba.bundle_adjust(_to_torch(prob), torch.from_numpy(np.array(CAM)))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert (inl_t.numpy().mean() < 0.95) == (outlier_frac > 0)
    # the fixed cameras stay exactly where they were
    np.testing.assert_array_equal(R_t.numpy()[:2], np.asarray(prob.cam_R)[:2])
