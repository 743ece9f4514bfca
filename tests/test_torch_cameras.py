"""The port's distorted camera models (`utils/cameras.py`) against the JAX
reference on the same seeded inputs: pinhole with radial-tangential
distortion (EuRoC-like coefficients) and Kannala-Brandt 8 (the fisheye
rig of tests/test_fisheye_stereo.py), projection, unprojection (the
reference's fixed iteration counts) and the closed-form Jacobians,
including points on and next to the optical axis
(tests/test_cameras.py::TestKB8::test_on_axis). Values at 1e-5 relative
(atol 1e-4 px, 1e-6 on z = 1 rays); Jacobians at rtol 1e-6, atol 1e-3, as
for the pinhole (test_torch_geometry.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.utils import cameras as jc  # noqa: E402
from orbslam3lib_tpu_torch.utils import cameras as tc  # noqa: E402

RADTAN = np.array([458.0, 457.0, 367.0, 248.0, -0.28340811, 0.07395907,
                   0.00019359, 1.76187114e-05, 0.0], np.float32)
KB8 = np.array([285.0, 285.0, 320.0, 200.0, 0.02, -0.01, 0.003, 0.0], np.float32)
MODELS = {"radtan": (tc.PINHOLE_RADTAN, RADTAN), "kb8": (tc.KANNALA_BRANDT, KB8)}


def _points(seed, n=256):
    rng = np.random.default_rng(seed)
    p = rng.uniform([-2.0, -1.5, 0.5], [2.0, 1.5, 10.0], (n, 3)).astype(np.float32)
    p[:3] = [[0.0, 0.0, 2.0], [1e-6, -1e-6, 3.0], [1e-3, 2e-3, 1.5]]   # on / near the axis
    return p


def _pixels(seed, params, n=256):
    rng = np.random.default_rng(seed)
    uv = rng.uniform([0.0, 0.0], [640.0, 400.0], (n, 2)).astype(np.float32)
    uv[:2] = [params[2:4], params[2:4] + np.float32(1e-4)]           # the principal point
    return uv


@pytest.mark.parametrize("name", sorted(MODELS))
def test_project_agrees(name):
    model, params = MODELS[name]
    p = _points(1)
    got = tc.project(model, torch.from_numpy(params), torch.from_numpy(p)).numpy()
    want = np.asarray(jc.project(model, jnp.asarray(params), jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_unproject_agrees(name):
    model, params = MODELS[name]
    uv = _pixels(2, params)
    got = tc.unproject(model, torch.from_numpy(params), torch.from_numpy(uv)).numpy()
    want = np.asarray(jc.unproject(model, jnp.asarray(params), jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:, 2], 1.0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jacobian_agrees(name):
    model, params = MODELS[name]
    p = _points(3)[3:]           # the reference's KB8 Jacobian divides by r
    got = tc.project_jac(model, torch.from_numpy(params), torch.from_numpy(p)).numpy()
    want = np.asarray(jc.project_jac(model, jnp.asarray(params), jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


def test_kb8_on_axis():
    """tests/test_cameras.py::TestKB8::test_on_axis: the principal point
    unprojects to the optical axis and back, in both packages alike."""
    P = torch.from_numpy(KB8)
    ray = tc.kb8_unproject(P, torch.tensor([[320.0, 200.0]]))
    np.testing.assert_allclose(ray.numpy(), [[0.0, 0.0, 1.0]], atol=1e-6)
    uv = tc.kb8_project(P, torch.tensor([[0.0, 0.0, 2.0]]))
    np.testing.assert_allclose(uv.numpy(), [[320.0, 200.0]], atol=1e-5)
    np.testing.assert_allclose(
        uv.numpy(), np.asarray(jc.kb8_project(jnp.asarray(KB8), jnp.asarray([[0.0, 0.0, 2.0]]))))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_roundtrip(name):
    """unproject(project(p)) recovers the bearing of p (reference
    tests/test_rectify.py / test_cameras.py roundtrips)."""
    model, params = MODELS[name]
    p = _points(4)
    p = p[np.abs(p[:, :2]).max(axis=1) / p[:, 2] < 0.6]
    P = torch.from_numpy(params)
    ray = tc.unproject(model, P, tc.project(model, P, torch.from_numpy(p))).numpy()
    np.testing.assert_allclose(ray * p[:, 2:3], p, rtol=0, atol=2e-3)
