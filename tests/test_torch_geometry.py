"""The port's math substrate against the JAX reference on the same seeded
inputs: SO(3)/SE(3) (utils/lie), the camera models (utils/cameras), the
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


# (model id, params, project tolerance, unproject tolerance): pinhole is one
# multiply-add per coordinate; the distorted models iterate (8 fixed-point
# steps, 10 Newton steps) and agree to 1e-5 relative
CAMERA_PARAMS = {
    "pinhole": (tc.PINHOLE, [300.0, 310.0, 320.0, 200.0],
                dict(rtol=1e-6, atol=1e-4), dict(rtol=0, atol=1e-5)),
    "radtan": (tc.PINHOLE_RADTAN, [300.0, 310.0, 320.0, 200.0, -0.28340811,
                                   0.07395907, 0.00019359, 1.76187114e-05, 0.0],
               dict(rtol=1e-5, atol=1e-4), dict(rtol=1e-5, atol=1e-5)),
    "kb8": (tc.KANNALA_BRANDT, [285.0, 285.0, 320.0, 200.0, 0.02, -0.01, 0.003, 0.0],
            dict(rtol=1e-5, atol=1e-4), dict(rtol=1e-5, atol=1e-5)),
}


@pytest.mark.parametrize("name", sorted(CAMERA_PARAMS))
def test_camera_models_agree(name):
    """project, unproject and project_jac dispatch every model id as the
    reference does (test_torch_cameras.py holds each model closer)."""
    model, params, tol_project, tol_unproject = CAMERA_PARAMS[name]
    params = np.asarray(params, np.float32)
    rng = np.random.default_rng(3)
    p = rng.normal(0, 1, (128, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.5
    uv = rng.uniform(0, 640, (128, 2)).astype(np.float32)
    P, T = jnp.asarray(params), torch.from_numpy(params)
    _close(tc.project(model, T, torch.from_numpy(p)),
           jc.project(model, P, jnp.asarray(p)), **tol_project)
    _close(tc.unproject(model, T, torch.from_numpy(uv)),
           jc.unproject(model, P, jnp.asarray(uv)), **tol_unproject)
    _close(tc.project_jac(model, T, torch.from_numpy(p)),
           jc.project_jac(model, P, jnp.asarray(p)), rtol=1e-6, atol=1e-3)


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


def test_right_jacobian_and_se3_matrix_agree():
    w = _rng_vecs(5)
    _close(tl.so3_right_jacobian(torch.from_numpy(w)), jl.so3_right_jacobian(jnp.asarray(w)))
    R = tl.so3_exp(torch.from_numpy(w))
    t = torch.from_numpy(_rng_vecs(6, scale=2.0))
    T = tl.se3_matrix(R, t)
    assert T.shape == (64, 4, 4)
    np.testing.assert_array_equal(T.numpy(), np.asarray(jl.se3_matrix(jnp.asarray(R.numpy()),
                                                                      jnp.asarray(t.numpy()))))


def test_triangulate_dlt_agrees():
    """Two cameras a baseline apart see seeded points: the port's DLT and
    the reference's on the same rays and projections (1e-4 of the points'
    2-8 m depths), both within 1e-3 of the true points."""
    rng = np.random.default_rng(7)
    X = np.stack([rng.uniform(-2, 2, 96), rng.uniform(-1, 1, 96), rng.uniform(2, 8, 96)],
                 -1).astype(np.float32)
    R2 = np.asarray(jl.so3_exp(jnp.asarray([0.02, -0.05, 0.01], jnp.float32)))
    t2 = np.array([-0.3, 0.02, 0.05], np.float32)
    T1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    T2 = np.concatenate([R2, t2[:, None]], 1).astype(np.float32)
    ray1, ray2 = X, X @ R2.T + t2
    T1b, T2b = np.broadcast_to(T1, (96, 3, 4)), np.broadcast_to(T2, (96, 3, 4))
    pt = tc.triangulate_dlt(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in (ray1, ray2, T1b, T2b)))
    pj = jc.triangulate_dlt(*(jnp.asarray(a) for a in (ray1, ray2, T1b, T2b)))
    _close(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pt.numpy(), X, rtol=0, atol=1e-3)


def test_huber_cost_agrees():
    rng = np.random.default_rng(8)
    chi2 = np.concatenate([rng.uniform(0, 30, 200), [0.0, tr.CHI2_MONO, tr.CHI2_STEREO]])
    chi2 = chi2.astype(np.float32)
    for delta in (tr.DELTA_MONO, tr.DELTA_STEREO):
        _close(tr.huber_cost(torch.from_numpy(chi2), delta),
               jr.huber_cost(jnp.asarray(chi2), delta), rtol=1e-6, atol=1e-5)
