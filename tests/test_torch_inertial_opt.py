"""The port's inertial solvers (`orbslam3lib_tpu_torch/tracking/
inertial_opt.py`) against the JAX reference's on the same inputs, on the
CPU: the 15-dof per-frame solve, the 30-dof LastFrame solve with its prior
and Schur-marginalised H_marg, the chain of the two as
tests/test_inertial_opt.py runs it, and the IMU initialisation with and
without scale.

Tolerances: poses, velocities and biases 1e-4 absolute (observed ~1e-6);
inlier masks equal; H_marg 1e-3 relative to its largest entry (its entries
span 1e-2 to 1e8, and f32 J^T J sums of 600 rows differ in order);
initialisation gravity and biases 1e-4, scale 1e-4 relative, velocities
1e-3 m/s.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import jacfwd

from orbslam3lib_tpu.io.synthetic import synth_imu
from orbslam3lib_tpu.tracking import imu as jimu
from orbslam3lib_tpu.tracking import inertial_opt as jio
from orbslam3lib_tpu.tracking.pose_opt import PoseObs as JObs
from orbslam3lib_tpu_torch.tracking import imu as timu
from orbslam3lib_tpu_torch.tracking import inertial_opt as tio
from orbslam3lib_tpu_torch.tracking.pose_opt import PoseObs as TObs
from orbslam3lib_tpu_torch.utils import lie as tlie
from tests.test_imu import gt_state
from torch_parity import reference_lie  # noqa: E402,F401

CAM = np.array([300.0, 300.0, 320.0, 200.0], np.float32)
BF = 300.0 * 0.11


def state_np(t, bg=(0, 0, 0), ba=(0, 0, 0)):
    R_wb, v, p = gt_state(t)
    R = R_wb.T.astype(np.float32)
    return dict(R=R, t=(-R @ p).astype(np.float32), v=np.asarray(v, np.float32),
                bg=np.asarray(bg, np.float32), ba=np.asarray(ba, np.float32))


def jstate(d):
    return jio.InertialFrameState(**{k: jnp.asarray(v) for k, v in d.items()})


def tstate(d):
    return tio.InertialFrameState(**{k: torch.as_tensor(v) for k, v in d.items()})


def jstate_np(st):
    return {k: np.asarray(getattr(st, k)) for k in ("R", "t", "v", "bg", "ba")}


def obs_np(t, seed, n=200, noise_px=0.4, stereo=False, outliers=0):
    rng = np.random.default_rng(seed)
    st = state_np(t)
    Rwc, c = st["R"].T, -st["R"].T @ st["t"]
    p_c = rng.uniform([-2, -1.5, 2], [2, 1.5, 10], size=(n, 3)).astype(np.float32)
    p_w = (p_c @ Rwc.T + c).astype(np.float32)
    uv = (CAM[:2] * p_c[:, :2] / p_c[:, 2:] + CAM[2:]).astype(np.float32)
    uv += rng.normal(0, noise_px, uv.shape).astype(np.float32)
    uv[:outliers] += rng.uniform(20, 40, (outliers, 2)).astype(np.float32)
    is_st = np.zeros(n, bool) if not stereo else rng.uniform(size=n) < 0.6
    u_r = np.where(is_st, uv[:, 0] - BF / p_c[:, 2], 0).astype(np.float32)
    lvl = rng.integers(0, 3, n)
    return dict(p_world=p_w, uv=uv, inv_sigma2=(1.2 ** (-2.0 * lvl)).astype(np.float32),
                u_right=u_r, is_stereo=is_st, valid=rng.uniform(size=n) < 0.95)


def preint_pair(t0, t1, bg=np.zeros(3), seed=0):
    rng = np.random.default_rng(seed)
    g, a, d = synth_imu(t0, t1, freq=200.0, bg=bg, sigma_g=2.4e-3, sigma_a=2.8e-2, rng=rng)
    pj = jimu.integrate(jimu.empty_preintegrated(), jnp.asarray(g), jnp.asarray(a),
                        jnp.asarray(d), jnp.ones(len(d), bool), jnp.float32(2.4e-3),
                        jnp.float32(2.8e-2), jnp.float32(1.9e-5), jnp.float32(3e-3))
    return pj, timu.Preintegrated.from_arrays(pj)


def perturbed(d, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    dR = np.asarray(tlie.so3_exp(torch.as_tensor(rng.normal(size=3).astype(np.float32) * scale)))
    out = dict(d)
    out["R"] = (dR @ d["R"]).astype(np.float32)
    out["t"] = (d["t"] + rng.normal(size=3) * scale).astype(np.float32)
    out["v"] = (d["v"] + rng.normal(size=3) * 5 * scale).astype(np.float32)
    return out


def assert_state_close(st_t, st_j, atol=1e-4):
    for k in ("R", "t", "v", "bg", "ba"):
        np.testing.assert_allclose(getattr(st_t, k).numpy(), np.asarray(getattr(st_j, k)),
                                   atol=atol, rtol=0, err_msg=k)


def assert_H_close(Ht, Hj, rel=1e-3):
    Hj = np.asarray(Hj)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=0, atol=rel * np.abs(Hj).max())


@pytest.mark.parametrize("stereo,outliers", [(False, 0), (True, 12)])
def test_pose_inertial_optimization(stereo, outliers):
    t0, t1 = 1.0, 1.0 + 1 / 15
    anchor = state_np(t0)
    pj, pt = preint_pair(t0, t1, seed=1)
    cur = perturbed(state_np(t1), seed=2)
    o = obs_np(t1, seed=3, stereo=stereo, outliers=outliers)
    sj, mj, nj, Hj = jio.pose_inertial_optimization(
        jstate(cur), jstate(anchor), pj, JObs(**{k: jnp.asarray(v) for k, v in o.items()}),
        jnp.asarray(CAM), bf=BF)
    st, mt, nt, Ht = tio.pose_inertial_optimization(
        tstate(cur), tstate(anchor), pt, TObs(**{k: torch.as_tensor(v) for k, v in o.items()}),
        torch.as_tensor(CAM), bf=BF)
    assert_state_close(st, sj)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert int(nt) == int(nj)
    assert_H_close(Ht, Hj)


def test_prior_chain_last_frame():
    """tests/test_inertial_opt.py's chain: a frame solved against its anchor
    gives the state and H of the next frame's LastFrame prior; the next
    frame has weak vision (12 points, 3 px), so the prior carries it."""
    t0, t1, t2 = 1.0, 1.05, 1.1
    pj1, pt1 = preint_pair(t0, t1, seed=4)
    o1 = obs_np(t1, seed=5, n=300, noise_px=0.2)
    sj1, _, _, Hj1 = jio.pose_inertial_optimization(
        jstate(state_np(t1)), jstate(state_np(t0)), pj1,
        JObs(**{k: jnp.asarray(v) for k, v in o1.items()}), jnp.asarray(CAM))
    st1, _, _, Ht1 = tio.pose_inertial_optimization(
        tstate(state_np(t1)), tstate(state_np(t0)), pt1,
        TObs(**{k: torch.as_tensor(v) for k, v in o1.items()}), torch.as_tensor(CAM))
    assert_state_close(st1, sj1)
    assert_H_close(Ht1, Hj1)
    # the second solve starts from the same prior in both packages
    prior_np = jstate_np(sj1)
    Hp = np.asarray(Hj1)
    pj2, pt2 = preint_pair(t1, t2, seed=6)
    o2 = obs_np(t2, seed=7, n=12, noise_px=3.0)
    start = state_np(t2)
    sj2, mj2, nj2, Hj2 = jio.pose_inertial_optimization_last_frame(
        jstate(start), jstate(prior_np), jnp.asarray(Hp), pj2,
        JObs(**{k: jnp.asarray(v) for k, v in o2.items()}), jnp.asarray(CAM))
    st2, mt2, nt2, Ht2 = tio.pose_inertial_optimization_last_frame(
        tstate(start), tstate(prior_np), torch.as_tensor(Hp), pt2,
        TObs(**{k: torch.as_tensor(v) for k, v in o2.items()}), torch.as_tensor(CAM))
    assert_state_close(st2, sj2)
    assert np.array_equal(mt2.numpy(), np.asarray(mj2))
    assert_H_close(Ht2, Hj2)
    # and a third frame chained on the port's own marginal
    pj3, pt3 = preint_pair(t2, 1.15, seed=8)
    o3 = obs_np(1.15, seed=9, n=100)
    sj3, _, _, Hj3 = jio.pose_inertial_optimization_last_frame(
        jstate(state_np(1.15)), sj2, Hj2, pj3,
        JObs(**{k: jnp.asarray(v) for k, v in o3.items()}), jnp.asarray(CAM))
    st3, _, _, Ht3 = tio.pose_inertial_optimization_last_frame(
        tstate(state_np(1.15)), st2, Ht2, pt3,
        TObs(**{k: torch.as_tensor(v) for k, v in o3.items()}), torch.as_tensor(CAM))
    assert_state_close(st3, sj3)
    assert_H_close(Ht3, Hj3)


@pytest.mark.parametrize("opt_scale", [False, True])
def test_inertial_init_optimization(opt_scale):
    ts = np.arange(0.5, 3.6, 0.25)
    bg_true = np.array([0.01, -0.015, 0.02])
    K = len(ts)
    kf = [state_np(float(t)) for t in ts]
    kf_R = np.stack([k["R"] for k in kf])
    kf_t = np.stack([k["t"] for k in kf])
    if opt_scale:          # a monocular map: the centres at 0.6 of their size
        kf_t = (0.6 * kf_t).astype(np.float32)
    pairs = [preint_pair(float(ts[i]), float(ts[i + 1]), bg=bg_true, seed=10 + i)
             for i in range(K - 1)]
    pj = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[p[0] for p in pairs])
    pt = timu.Preintegrated.stack([p[1] for p in pairs])
    outj = jio.inertial_init_optimization(jnp.asarray(kf_R), jnp.asarray(kf_t),
                                          jnp.ones(K, bool), pj, jnp.ones(K - 1, bool),
                                          opt_scale=opt_scale)
    outt = tio.inertial_init_optimization(torch.as_tensor(kf_R), torch.as_tensor(kf_t),
                                          torch.ones(K, dtype=torch.bool), pt,
                                          torch.ones(K - 1, dtype=torch.bool),
                                          opt_scale=opt_scale)
    for name, a, b, tol in zip(("R_wg", "bg", "ba", "s", "v"), outt, outj,
                               (1e-4, 1e-4, 1e-4, 1e-4, 1e-3)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol * max(1.0, np.abs(b).max()),
                                   err_msg=name)


def test_detach_drops_the_tangent():
    """The Huber weights are detached inside the residual: under jacfwd a
    detached factor carries no tangent (the reference's stop_gradient)."""
    x = torch.tensor([0.5, -2.0, 3.0])
    J = jacfwd(lambda y: (y * y).detach() * y)(x)
    assert torch.equal(J, torch.diag(x * x))


@pytest.mark.parametrize("theta,noisy", [(1e-5, False), (2.5e-4, True), (1e-2, False)])
def test_reference_small_angle_jacobian_fault(theta, noisy):
    """A reference fault both packages carry (`utils/lie.py`'s
    `_sin_cos_coeffs`, the port's copy of it): the series are used only for
    theta^2 < 1e-8, so between theta ~1e-4 and ~1e-2 (1 - cos)/theta^2 and
    (theta - sin)/theta^3 cancel in f32. Harmless in value (they multiply
    hat(w)^2, of order theta^2), their forward-mode derivatives are rounding
    noise: the reference's f32 `jax.jacfwd` of `se3_exp` at theta = 2.5e-4
    (a per-frame solve's chart point) is off the f64 one by more than 1e-3,
    below 1e-6 outside that band. The card rounds that noise otherwise than
    the CPU (tests/test_torch_cuda.py's H_marg tolerance)."""
    from orbslam3lib_tpu.utils import lie as jlie
    x = np.array([0.02, -0.02, 0.003, theta, 0.3 * theta, -0.5 * theta])

    def flat(v):
        R, t = jlie.se3_exp(v)
        return jnp.concatenate([R.reshape(-1), t])

    J32 = np.asarray(jax.jacfwd(flat)(jnp.asarray(x, jnp.float32)), np.float64)
    J64 = tio.jacobian_fwd(lambda v: (torch.cat([tlie.se3_exp(v)[0].reshape(v.shape[0], -1),
                                                 tlie.se3_exp(v)[1]], -1),),
                           torch.as_tensor(x, dtype=torch.float64))[1].numpy()
    err = np.abs(J32 - J64).max()
    assert (err > 1e-3) if noisy else (err < 1e-6), err
