"""The port's IMU preintegration (`orbslam3lib_tpu_torch/tracking/imu.py`)
against the JAX reference's on the same numpy inputs, on the CPU: 200
samples integrated with noise and bias random walk (every field: the
deltas, the covariance, the bias Jacobians), from a non-empty state in two
pieces, and as a batch of two with their own starting states and biases
(the tracker's frame and keyframe preintegrations); the bias-corrected
deltas, `predict_state`, `inertial_residual` and the T_bc helpers with a
rotated and shifted extrinsic; and the synthetic IMU of `io/synthetic.py`
against the reference's, sample for sample.

Tolerances: 1e-5 relative to each field's largest entry (f32 products of
200 steps in another order; observed ~3e-7), the batch against the single
runs 2e-6 relative; the helpers 1e-5 absolute.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3lib_tpu.io import synthetic as jsyn
from orbslam3lib_tpu.tracking import imu as jimu
from orbslam3lib_tpu_torch.io import synthetic as tsyn
from orbslam3lib_tpu_torch.tracking import imu as timu
from orbslam3lib_tpu_torch.utils import lie as tlie
from torch_parity import reference_lie  # noqa: E402,F401

SIG = (2.4e-3, 2.8e-2, 1.9e-5, 3e-3)     # cfg.imu's discrete sigmas and walks at 200 Hz


def samples(seed, n=200):
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    a = (rng.normal(0, 1.0, (n, 3)) + [0, -9.81, 0]).astype(np.float32)
    d = rng.uniform(0.004, 0.006, n).astype(np.float32)
    return g, a, d


def jax_integrate(pre, g, a, d):
    return jimu.integrate(pre, jnp.asarray(g), jnp.asarray(a), jnp.asarray(d),
                          jnp.ones(len(d), bool), *(jnp.float32(x) for x in SIG))


def assert_fields_close(pt, pj, rel=1e-5):
    for f in timu.TENSOR_FIELDS:
        x, y = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        np.testing.assert_allclose(x, y, rtol=0, atol=rel * max(np.abs(y).max(), 1e-30),
                                   err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_integrate_matches_reference(seed):
    g, a, d = samples(seed)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.1, 0.05, -0.02], np.float32)
    pj = jax_integrate(jimu.empty_preintegrated(jnp.asarray(bg), jnp.asarray(ba)), g, a, d)
    pt = timu.integrate(timu.empty_preintegrated(torch.as_tensor(bg), torch.as_tensor(ba)),
                        g, a, d, *SIG)
    assert_fields_close(pt, pj)
    assert pt.dt_host == pytest.approx(float(np.sum(d, dtype=np.float64)), abs=1e-9)
    # carried across: the reference's state continued by the port
    g2, a2, d2 = samples(seed + 10, 50)
    pj2 = jax_integrate(pj, g2, a2, d2)
    pt2 = timu.integrate(timu.Preintegrated.from_arrays(pj), g2, a2, d2, *SIG)
    assert_fields_close(pt2, pj2)


def test_batch_of_two_matches_single_runs():
    """The frame's and the keyframe's preintegrations integrated as one
    batch: each equals its own single run (and the reference's)."""
    g0, a0, d0 = samples(3, 40)
    g, a, d = samples(4, 13)
    z = timu.empty_preintegrated()
    kf = timu.integrate(timu.empty_preintegrated(torch.tensor([0.01, 0.0, -0.01]),
                                                 torch.tensor([0.0, 0.1, 0.0])),
                        g0, a0, d0, *SIG)           # a keyframe gap already under way
    both = timu.integrate(timu.Preintegrated.stack([z, kf]), g, a, d, *SIG)
    for i, start in enumerate((z, kf)):
        single = timu.integrate(start, g, a, d, *SIG)
        for f in timu.TENSOR_FIELDS:
            y = getattr(single, f).numpy()
            np.testing.assert_allclose(getattr(both[i], f).numpy(), y, rtol=0,
                                       atol=2e-6 * max(np.abs(y).max(), 1e-30), err_msg=f)
        assert both[i].dt_host == pytest.approx(single.dt_host)
    pj = jax_integrate(jimu.empty_preintegrated(), g, a, d)
    assert_fields_close(both[0], pj)


def _pose(rng):
    R = tlie.so3_exp(torch.as_tensor(rng.normal(size=3).astype(np.float32))).numpy()
    return R, rng.normal(size=3).astype(np.float32)


def test_prediction_residual_and_extrinsic_helpers():
    rng = np.random.default_rng(7)
    g, a, d = samples(5, 60)
    pj = jax_integrate(jimu.empty_preintegrated(), g, a, d)
    pt = timu.Preintegrated.from_arrays(pj)
    R_bc, t_bc = _pose(rng)
    t_bc *= 0.1
    Rcw, tcw = _pose(rng)
    T = torch.as_tensor
    for x, y in zip(timu.body_from_cam(T(Rcw), T(tcw), T(R_bc), T(t_bc)),
                    jimu.body_from_cam(*(jnp.asarray(v) for v in (Rcw, tcw, R_bc, t_bc)))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5)
    Rwb, p = timu.body_from_cam(T(Rcw), T(tcw), T(R_bc), T(t_bc))
    back = timu.cam_from_body(Rwb, p, T(R_bc), T(t_bc))
    np.testing.assert_allclose(back[0].numpy(), Rcw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(back[1].numpy(), tcw, rtol=0, atol=1e-5)
    v = rng.normal(size=3).astype(np.float32)
    bg, ba = (rng.normal(0, 0.01, 3).astype(np.float32) for _ in range(2))
    outs_t = timu.predict_state(Rwb, T(v), p, pt, T(bg), T(ba))
    outs_j = jimu.predict_state(jnp.asarray(Rwb.numpy()), jnp.asarray(v),
                                jnp.asarray(p.numpy()), pj, jnp.asarray(bg), jnp.asarray(ba))
    for x, y in zip(outs_t, outs_j):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5)
    R2, t2 = _pose(rng)
    v2 = rng.normal(size=3).astype(np.float32)
    rt = timu.inertial_residual(Rwb, T(v), p, T(R2), T(v2), T(t2), T(bg), T(ba), pt)
    rj = jimu.inertial_residual(jnp.asarray(Rwb.numpy()), jnp.asarray(v),
                                jnp.asarray(p.numpy()), jnp.asarray(R2), jnp.asarray(v2),
                                jnp.asarray(t2), jnp.asarray(bg), jnp.asarray(ba), pj)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-5)
    for x, y in zip(timu.corrected_deltas(pt, T(bg), T(ba)),
                    jimu.corrected_deltas(pj, jnp.asarray(bg), jnp.asarray(ba))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5)


def test_synth_imu_matches_reference():
    """`io.synthetic.synth_imu` with a rotated, shifted extrinsic, noise and
    biases, one generator through three calls: the reference's samples;
    `corridor_imu_stream` is those calls over a frame sequence."""
    R_bc = np.asarray(tlie.so3_exp(torch.tensor([0.1, -0.2, 0.05])).numpy(), np.float64)
    kw = dict(bg=np.array([0.002, -0.001, 0.0015]), ba=np.array([0.02, -0.01, 0.015]),
              sigma_g=2.4e-3, sigma_a=2.8e-2, R_bc=R_bc, t_bc=np.array([0.05, 0.0, -0.02]))
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for t0, t1 in ((0.0, 1 / 15), (1 / 15, 2 / 15), (5.0, 5.25)):
        for x, y in zip(tsyn.synth_imu(t0, t1, rng=r1, **kw), jsyn.synth_imu(t0, t1, rng=r2, **kw)):
            assert np.array_equal(x, y)
    ts = np.arange(4) / 15.0
    stream = tsyn.corridor_imu_stream(ts, 1.7e-4, 2.0e-3, 200.0, kw["bg"], kw["ba"], seed=0)
    rng = np.random.default_rng(0)
    assert stream[0] is None and len(stream) == 4
    for i in range(1, 4):
        want = jsyn.synth_imu(ts[i - 1], ts[i], freq=200.0, bg=kw["bg"], ba=kw["ba"],
                              sigma_g=1.7e-4 * np.sqrt(200.0), sigma_a=2.0e-3 * np.sqrt(200.0),
                              rng=rng)
        for x, y in zip(stream[i], want):
            assert np.array_equal(x, y)
