"""The port's math substrate against the JAX reference on the same seeded
inputs: SO(3)/SE(3) (utils/lie), the pinhole camera (utils/cameras), the
Huber weight (utils/robust) and the arithmetic gates (ops/masks). All f32;
the two frameworks evaluate transcendental functions and sums with
different roundings, so values agree to a few f32 ulps (held at 1e-5
absolute on O(1) values), and the exact gates (step01, leq_int, penalize)
bit for bit."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.ops import masks as jm  # noqa: E402
from orbslam3lib_tpu.utils import cameras as jc, lie as jl, robust as jr  # noqa: E402
from orbslam3lib_tpu_torch.ops import masks as tm  # noqa: E402
from orbslam3lib_tpu_torch.utils import cameras as tc, lie as tl, robust as tr  # noqa: E402

TOL = dict(rtol=0, atol=1e-5)


def _rng_vecs(seed, n=64, scale=1.0):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, scale, (n, 3)).astype(np.float32)
    w[:4] *= 1e-5                      # small-angle series branch
    return w


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(kw or TOL))


def test_so3_se3_agree():
    w = _rng_vecs(0)
    rho = _rng_vecs(1)
    _close(tl.hat(torch.from_numpy(w)), jl.hat(jnp.asarray(w)))
    R_t, R_j = tl.so3_exp(torch.from_numpy(w)), jl.so3_exp(jnp.asarray(w))
    _close(R_t, R_j)
    _close(tl.so3_log(R_t), jl.so3_log(R_j), rtol=0, atol=1e-4)
    _close(tl.normalize_rotation(R_t), jl.normalize_rotation(R_j))
    xi = np.concatenate([rho, w], axis=1)
    (Rt, tt), (Rj, tj) = tl.se3_exp(torch.from_numpy(xi)), jl.se3_exp(jnp.asarray(xi))
    _close(Rt, Rj)
    _close(tt, tj)
    for a, b in zip(tl.se3_inverse(Rt, tt), jl.se3_inverse(Rj, tj)):
        _close(a, b)
    for a, b in zip(tl.se3_compose(Rt, tt, Rt.flip(0), tt.flip(0)),
                    jl.se3_compose(Rj, tj, Rj[::-1], tj[::-1])):
        _close(a, b)
    p = _rng_vecs(2, scale=3.0)
    _close(tl.se3_apply(Rt[0], tt[0], torch.from_numpy(p)),
           jl.se3_apply(Rj[0], tj[0], jnp.asarray(p)))


def test_pinhole_agrees_and_other_models_raise():
    params = np.array([300.0, 310.0, 320.0, 200.0], np.float32)
    rng = np.random.default_rng(3)
    p = rng.normal(0, 1, (128, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.5
    uv = rng.uniform(0, 640, (128, 2)).astype(np.float32)
    P, T = jnp.asarray(params), torch.from_numpy(params)
    _close(tc.project(tc.PINHOLE, T, torch.from_numpy(p)),
           jc.project(jc.PINHOLE, P, jnp.asarray(p)), rtol=1e-6, atol=1e-4)
    _close(tc.unproject(tc.PINHOLE, T, torch.from_numpy(uv)),
           jc.unproject(jc.PINHOLE, P, jnp.asarray(uv)))
    _close(tc.project_jac(tc.PINHOLE, T, torch.from_numpy(p)),
           jc.project_jac(jc.PINHOLE, P, jnp.asarray(p)), rtol=1e-6, atol=1e-3)
    for model in (tc.KANNALA_BRANDT, tc.PINHOLE_RADTAN):
        with pytest.raises(NotImplementedError):
            tc.project(model, T, torch.from_numpy(p))


def test_robust_and_masks_agree():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-5, 300, 200),
                        np.arange(-3, 5, 0.5)]).astype(np.float32)
    X, J = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(tm.step01(X).numpy(), np.asarray(jm.step01(J)))
    np.testing.assert_array_equal(tm.leq_int(X, 75.0).numpy(), np.asarray(jm.leq_int(J, 75.0)))
    g = tm.step01(X / 7.0)
    np.testing.assert_array_equal(tm.penalize(X, g).numpy(),
                                  np.asarray(jm.penalize(J, jm.step01(J / 7.0))))
    np.testing.assert_array_equal(tm.is_finite_match(X * 10).numpy(),
                                  np.asarray(jm.is_finite_match(J * 10)))
    chi2 = np.abs(x)
    _close(tr.huber_weight(torch.from_numpy(chi2), tr.DELTA_STEREO),
           jr.huber_weight(jnp.asarray(chi2), jr.DELTA_STEREO))
    assert (tm.BIG, tr.CHI2_MONO, tr.CHI2_STEREO) == (jm.BIG, jr.CHI2_MONO, jr.CHI2_STEREO)
