"""Sim(3) and the loop leg's optimisers of the port against the JAX
reference: the Sim(3) group (utils/lie), Horn, Sim3 RANSAC and OptimizeSim3
(mapping/sim3) on tests/test_sim3_posegraph.py's problem (150 points, 20%
outliers, s = 1.15), the essential-graph optimiser (mapping/pose_graph) in
its three modes on a drifted chain with a loop edge, and the global BA
(mapping/map_ba) on tests/test_global_ba.py's noisy map, with its abort.

RANSAC runs on the reference's own draws (`jax.random.choice` with the
reference's key, passed in as `hyp_idx`), so its inlier masks and counts
are equal. Tolerances: the group maps within 1e-5 (2e-4 for logs near
large angles, as tests/test_lie.py); Sim3 estimates within 1e-4 (f32 SVD
and GN solves by other LAPACK calls); pose-graph poses within 1e-4 after 15
GN steps; global BA poses within 1e-4 (ten LM steps, as
test_torch_local_ba.py) and its points, 6-14 m away, within 5e-4 (observed
2e-4: the dense f32 Schur system of six cameras and 300 points, summed in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.mapping import map_ba as jmb, pose_graph as jpg, sim3 as jsim  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms  # noqa: E402
from orbslam3lib_tpu.utils import cameras as jcam, lie as jl  # noqa: E402
from orbslam3lib_tpu_torch.mapping import map_ba as tmb, pose_graph as tpg, sim3 as tsim  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402
from orbslam3lib_tpu_torch.utils import lie as tl, sampling  # noqa: E402

from torch_parity import reference_draws  # noqa: E402

CAM = np.array([300.0, 300.0, 320.0, 200.0], np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


# -- the Sim(3) group ---------------------------------------------------------

def _xi(rng, n, scale, sigma):
    xi = (rng.normal(size=(n, 7)) * scale).astype(np.float32)
    xi[:, 6] = sigma
    return xi


@pytest.mark.parametrize("scale,sigma", [(0.5, 0.0), (0.4, 0.3), (1e-6, 0.2),
                                         (0.6, 1e-6), (1e-7, 1e-7)])
def test_sim3_exp_log_agree(scale, sigma):
    """exp, log, inverse, compose and apply against the reference, in each
    of _sim3_W's regimes (general, small angle, small scale, both)."""
    rng = np.random.default_rng(3)
    xi = _xi(rng, 16, scale, sigma)
    Rj, tj, sj = jl.sim3_exp(jnp.asarray(xi))
    Rt, tt, st = tl.sim3_exp(t(xi))
    for a, b in ((Rt, Rj), (tt, tj), (st, sj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl.sim3_log(Rt, tt, st).numpy(),
                               np.asarray(jl.sim3_log(Rj, tj, sj)), rtol=0, atol=2e-4)
    inv_t, inv_j = tl.sim3_inverse(Rt, tt, st), jl.sim3_inverse(Rj, tj, sj)
    comp_t = tl.sim3_compose(Rt, tt, st, *inv_t)
    comp_j = jl.sim3_compose(Rj, tj, sj, *inv_j)
    for a, b in zip(inv_t + comp_t, inv_j + comp_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    p = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(tl.sim3_apply(Rt, tt, st, t(p)).numpy(),
                               np.asarray(jl.sim3_apply(Rj, tj, sj, jnp.asarray(p))),
                               rtol=0, atol=1e-5)


def test_sim3_cases_of_test_lie():
    """tests/test_lie.py's Sim(3) cases on the port: sigma = 0 reduces to
    SE(3), S S^-1 = I, scale acts on points."""
    rng = np.random.default_rng(4)
    xi7 = np.zeros((4, 7), np.float32)
    xi7[:, :6] = rng.normal(size=(4, 6)) * 0.5
    R, tt, s = tl.sim3_exp(t(xi7))
    R2, t2 = tl.se3_exp(t(xi7[:, :6]))
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(R.numpy(), R2.numpy(), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), t2.numpy(), atol=1e-4)
    xi = (rng.normal(size=7) * 0.4).astype(np.float32)
    R, tt, s = tl.sim3_exp(t(xi))
    Rc, tc, sc = tl.sim3_compose(R, tt, s, *tl.sim3_inverse(R, tt, s))
    np.testing.assert_allclose(Rc.numpy(), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(float(sc), 1.0, atol=1e-5)
    xi = np.zeros(7, np.float32)
    xi[6] = np.log(2.0)
    R, tt, s = tl.sim3_exp(t(xi))
    p = np.array([1.0, 2.0, 3.0], np.float32)
    np.testing.assert_allclose(tl.sim3_apply(R, tt, s, t(p)).numpy(), 2.0 * p, atol=1e-4)


def test_se3_log_and_vee_agree():
    rng = np.random.default_rng(5)
    xi = (rng.normal(size=(32, 6)) * 0.8).astype(np.float32)
    R, tt = jl.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(tl.se3_log(t(R), t(tt)).numpy(),
                               np.asarray(jl.se3_log(R, tt)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl.se3_log(t(R), t(tt)).numpy(), xi, rtol=0, atol=2e-4)
    W = tl.hat(t(xi[:, 3:]))
    np.testing.assert_array_equal(tl.vee(W).numpy(), np.asarray(jl.vee(jnp.asarray(W.numpy()))))


def test_sim3_functions_trace_in_forward_mode():
    """The port's group maps are pure: the forward-mode Jacobian of
    log(exp(xi)) (`lie.value_and_rowwise_jacobian`, rows independent) is
    the identity at zero and at generic points, and stays f32."""
    x0 = torch.tensor([[0.0] * 7, [0.1, -0.2, 0.3, 0.05, -0.1, 0.2, 0.1],
                       [0.3, 0.1, -0.2, 1e-6, 0.0, 0.0, 1e-6]])
    y, J = tl.value_and_rowwise_jacobian(lambda x: tl.sim3_log(*tl.sim3_exp(x)), x0)
    np.testing.assert_allclose(y.numpy(), x0.numpy(), atol=1e-6)
    assert J.shape == (3, 7, 7) and J.dtype == torch.float32
    np.testing.assert_allclose(J.numpy(), np.broadcast_to(np.eye(7), J.shape), atol=2e-3)


# -- the sampler -------------------------------------------------------------

def test_ransac_sampler_draws_only_valid_entries():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 7, 20, 41]] = True
    idx = sampling.ransac_indices(valid, 128, 6, seed=1)
    assert idx.shape == (128, 6) and valid[idx].all()
    assert set(idx.unique().tolist()) == {3, 7, 20, 41}
    assert torch.equal(idx, sampling.ransac_indices(valid, 128, 6, seed=1))
    none = sampling.ransac_indices(torch.zeros(50, dtype=torch.bool), 8, 3)
    assert none.shape == (8, 3) and int(none.max()) <= 49


# -- Horn, Sim3 RANSAC, OptimizeSim3 -----------------------------------------

def sim3_problem(seed=61, n=150, outlier_frac=0.2, s_true=1.15):
    rng = np.random.default_rng(seed)
    p2 = rng.uniform([-2, -1.5, 3], [2, 1.5, 9], size=(n, 3)).astype(np.float32)
    xi = np.zeros(7, np.float32)
    xi[:6] = rng.normal(size=6) * 0.2
    xi[6] = np.log(s_true)
    R, tt, s = (np.asarray(x) for x in jl.sim3_exp(jnp.asarray(xi)))
    p1 = (s * p2 @ R.T + tt).astype(np.float32)
    p1 += rng.normal(0, 0.005, p1.shape).astype(np.float32)
    n_out = int(n * outlier_frac)
    p1[:n_out] += rng.uniform(0.5, 2.0, (n_out, 3)).astype(np.float32)
    uv1 = np.asarray(jcam.pinhole_project(jnp.asarray(CAM), jnp.asarray(p1)))
    uv2 = np.asarray(jcam.pinhole_project(jnp.asarray(CAM), jnp.asarray(p2)))
    valid = np.ones(n, bool)
    valid[-10:] = False
    return (R, tt, float(s)), p1, p2, uv1, uv2, valid


def test_horn_sim3_agrees():
    _, p1, p2, _, _, _ = sim3_problem(outlier_frac=0.0)
    w = np.random.default_rng(0).uniform(0.5, 1.0, len(p1)).astype(np.float32)
    for fix in (False, True):
        got = tsim.horn_sim3(t(p1), t(p2), t(w), fix)
        want = jsim.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w), fix)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_on_reference_draws(fix_scale):
    truth, p1, p2, uv1, uv2, valid = sim3_problem()
    idx = reference_draws(valid, 128, 3)
    got = tsim.sim3_ransac(t(p1), t(p2), t(uv1), t(uv2), t(valid), t(CAM),
                           fix_scale=fix_scale, hyp_idx=t(idx))
    want = jsim.sim3_ransac(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(uv1),
                            jnp.asarray(uv2), jnp.asarray(valid), jnp.asarray(CAM),
                            fix_scale=fix_scale)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) > (0 if fix_scale else 90)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    if not fix_scale:
        assert abs(float(got[2]) - truth[2]) < 0.05


def test_sim3_ransac_own_sampler_finds_the_transform():
    truth, p1, p2, uv1, uv2, valid = sim3_problem()
    R, tt, s, inl, n = tsim.sim3_ransac(t(p1), t(p2), t(uv1), t(uv2), t(valid), t(CAM))
    assert int(n) > 90 and abs(float(s) - truth[2]) < 0.05
    assert inl.numpy()[:30].mean() < 0.2                     # outliers rejected


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_agrees(fix_scale):
    (R, tt, s), p1, p2, uv1, uv2, valid = sim3_problem(seed=62, outlier_frac=0.1)
    dxi = np.zeros(7, np.float32)
    dxi[:6] = np.random.default_rng(1).normal(size=6) * 0.02
    R0, t0, s0 = (np.asarray(x) for x in jl.sim3_compose(
        *jl.sim3_exp(jnp.asarray(dxi)), jnp.asarray(R), jnp.asarray(tt), jnp.float32(s)))
    got = tsim.optimize_sim3(t(R0), t(t0), t(np.float32(s0)), t(p1), t(p2), t(uv1),
                             t(uv2), t(valid), t(CAM), fix_scale=fix_scale)
    want = jsim.optimize_sim3(jnp.asarray(R0), jnp.asarray(t0), jnp.float32(s0),
                              jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(uv1),
                              jnp.asarray(uv2), jnp.asarray(valid), jnp.asarray(CAM),
                              fix_scale=fix_scale)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) > 100
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


# -- the essential graph -------------------------------------------------------

def chain_problem(mode, K=12, drift=0.02, seed=7):
    """tests/test_sim3_posegraph.py's chain: K poses, drifted estimates,
    sequential edges from the true relatives and one loop edge K-1 -> 0."""
    rng = np.random.default_rng(seed)
    xs = np.zeros((K, 7), np.float32)
    xs[:, 0] = 0.5 * np.arange(K)
    xs[:, 4] = 0.1 * np.arange(K)
    Rt_, tt_, _ = (np.asarray(x) for x in jl.sim3_exp(jnp.asarray(xs)))
    one = jnp.float32(1.0)
    rel = [jpg.relative_sim3(jnp.asarray(Rt_[i]), jnp.asarray(tt_[i]), one,
                             jnp.asarray(Rt_[i - 1]), jnp.asarray(tt_[i - 1]), one)
           for i in range(1, K)]
    R_est, t_est, s_est = [Rt_[0]], [tt_[0]], [1.0]
    for i in range(1, K):
        xi = np.zeros(7, np.float32)
        xi[:6] = rng.normal(size=6) * drift
        if mode == "sim3":
            xi[6] = rng.normal() * drift
        Rn, tn, sn = jl.sim3_compose(*jl.sim3_exp(jnp.asarray(xi)), *rel[i - 1])
        R2, t2, s2 = jl.sim3_compose(Rn, tn, sn, jnp.asarray(R_est[-1]),
                                     jnp.asarray(t_est[-1]), jnp.float32(s_est[-1]))
        R_est.append(np.asarray(R2)), t_est.append(np.asarray(t2)), s_est.append(float(s2))
    loop = jpg.relative_sim3(jnp.asarray(Rt_[K - 1]), jnp.asarray(tt_[K - 1]), one,
                             jnp.asarray(Rt_[0]), jnp.asarray(tt_[0]), one)
    edges = rel + [loop]
    ei = np.array(list(range(K - 1)) + [0], np.int32)
    ej = np.array(list(range(1, K)) + [K - 1], np.int32)
    eR = np.stack([np.asarray(e[0]) for e in edges])
    et = np.stack([np.asarray(e[1]) for e in edges])
    es = np.array([float(e[2]) for e in edges], np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    ev = np.ones(len(ei), bool)
    ev[3] = False                        # one invalid edge: masked out
    return (np.stack(R_est), np.stack(t_est), np.asarray(s_est, np.float32),
            np.ones(K, bool), fixed, ei, ej, eR, et, es, ev), tt_


@pytest.mark.parametrize("mode", ["sim3", "se3", "4dof"])
def test_optimize_pose_graph_agrees(mode):
    args, t_true = chain_problem(mode)
    got = tpg.optimize_pose_graph(*(t(a) for a in args), mode=mode, n_iters=15)
    want = jpg.optimize_pose_graph(*(jnp.asarray(a) for a in args), mode=mode, n_iters=15)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    err0 = np.linalg.norm(args[1] - t_true, axis=1).max()
    assert np.linalg.norm(got[1].numpy() - t_true, axis=1).max() < err0
    assert got[0][0].equal(t(args[0][0]))                 # the fixed pose stays


# -- the global BA --------------------------------------------------------------

def noisy_map(seed=9, n_pts=300, F=128, pose_noise=0.05, pt_noise=0.05):
    """tests/test_global_ba.py's map: six keyframes in a row, all but the
    first (the gauge) with noisy positions, noisy landmarks; 16 keyframe
    slots, so ten are empty."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -2, 6], [4, 2, 14], size=(n_pts, 3)).astype(np.float32)
    descs = rng.integers(0, 2, size=(n_pts, 256)).astype(np.int8)
    m = jms.empty_map(max_kf=16, max_mp=512, n_feat=F)
    for i in range(6):
        tt = np.array([0.5 * i, 0.02 * i, 0.0], np.float32)
        uv = np.asarray(jcam.pinhole_project(jnp.asarray(CAM), jnp.asarray(pts + tt)))
        ok = (uv[:, 0] > 2) & (uv[:, 0] < 638) & (uv[:, 1] > 2) & (uv[:, 1] < 398)
        sel = np.nonzero(ok)[0][:F]
        xy = np.zeros((F, 2), np.float32)
        xy[:len(sel)] = uv[sel]
        desc = np.zeros((F, 256), np.int8)
        desc[:len(sel)] = descs[sel]
        fv = np.zeros(F, bool)
        fv[:len(sel)] = True
        assoc = np.full(F, -1, np.int32)
        assoc[:len(sel)] = sel
        if i > 0:
            tt = tt + rng.normal(0, pose_noise, 3).astype(np.float32)
        m, _ = jms.insert_keyframe(m, jnp.eye(3), jnp.asarray(tt), jnp.float32(i),
                                   jnp.asarray(xy), jnp.zeros(F, jnp.int32),
                                   jnp.asarray(desc), jnp.asarray(fv),
                                   jnp.asarray(assoc), jnp.zeros(F, jnp.float32))
    mp_pos = np.zeros((512, 3), np.float32)
    mp_pos[:n_pts] = pts + rng.normal(0, pt_noise, pts.shape).astype(np.float32)
    mp_valid = np.zeros(512, bool)
    mp_valid[:n_pts] = True
    m = m._replace(mp_pos=jnp.asarray(mp_pos), mp_valid=jnp.asarray(mp_valid),
                   n_mp=jnp.int32(n_pts))
    return {k: np.asarray(v) for k, v in m._asdict().items()}


@pytest.mark.parametrize("n_iters,chunk,abort", [(10, 5, False), (100, 2, True)])
def test_global_bundle_adjust_agrees(n_iters, chunk, abort):
    """Ten LM steps in two chunks; and an abort polled after the first
    chunk of two, honoured at once in both packages."""
    m = noisy_map()
    polls = {"t": 0, "j": 0}

    def poll(key):
        def f():
            polls[key] += 1
            return abort
        return f
    got = tmb.global_bundle_adjust(tms.from_numpy(m), t(CAM), bf=33.0, n_iters=n_iters,
                                   chunk=chunk, n_ba_points=512, should_abort=poll("t"))
    want = jmb.global_bundle_adjust(jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()}),
                                    jnp.asarray(CAM), bf=33.0, n_iters=n_iters, chunk=chunk,
                                    n_ba_points=512, should_abort=poll("j"))
    assert polls["t"] == polls["j"] == (1 if abort else 2)
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("mp_pos", 5e-4)):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=tol, err_msg=f)
    np.testing.assert_array_equal(got.kf_t.numpy()[6:], m["kf_t"][6:])   # empty slots
    np.testing.assert_array_equal(got.kf_t.numpy()[0], m["kf_t"][0])     # the gauge
    assert np.abs(got.kf_t.numpy()[1:6] - m["kf_t"][1:6]).max() > 1e-3
