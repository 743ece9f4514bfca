"""The landmark-sharded bundle adjustment of the port
(`parallel/dist_ba.py`, `mapping/map_ba.global_bundle_adjust_dist` and
`_auto`) against the JAX reference's on tests/conftest.py's virtual CPU
mesh, on the cases of the reference's tests/test_dist_ba.py.

Tolerances:
- `partition_problem`: every array equal (a permutation and padding);
- `dist_bundle_adjust` against the reference's on a 2- and 4-device
  sub-mesh: poses within 1e-4 and inlier masks equal (the same f32 LM, its
  sums in another order, as tests/test_torch_local_ba.py); landmarks within
  5e-5 of (1 + |p|): a landmark held by outlier edges wanders from 10 to
  26 m over the iterations, and there both packages part by up to 2.4e-5
  of its distance (the reference's two solvers by 1.3e-4 m);
- against the port's own single-device `bundle_adjust`: R 2e-4, t 2e-3, the
  reference's tolerances between its two solvers (tests/test_dist_ba.py);
- `global_bundle_adjust_dist` on the ring world against the reference's:
  kf_R / kf_t 1e-4, landmarks 5e-4 (tests/test_torch_sim3.py's global BA
  tolerances);
- a `ProcessMesh` of two gloo ranks (spawned processes that import only
  torch and the port, 120 s timeout) against a `DeviceMesh` of two CPU
  shards: 1e-5 (the same sums, reduced by gloo).
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

torch.set_num_threads(2)

from orbslam3lib_tpu.mapping import local_ba as jba, map_ba as jmb  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms  # noqa: E402
from orbslam3lib_tpu.parallel import dist_ba as jdist  # noqa: E402
from orbslam3lib_tpu_torch.mapping import local_ba as tba, map_ba as tmb  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402
from orbslam3lib_tpu_torch.parallel import dist_ba as tdist  # noqa: E402

from test_local_ba import CAM, make_ba_problem  # noqa: E402
from torch_parity import reference_dist_edges, reference_small_angle, ring_world  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_ba_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _to_torch(prob):
    return tba.BAProblem(*(torch.from_numpy(np.array(x)) for x in prob))


def _mesh(n):
    devs = jax.devices("cpu")
    assert len(devs) >= n, "conftest forces 8 virtual CPU devices"
    return Mesh(np.array(devs[:n]), ("mp",))


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_partition_problem_equals_reference(n_shards):
    prob, _ = make_ba_problem(n_cams=4, n_pts=101)
    # an invalid edge and an uneven landmark spread
    prob = prob._replace(e_valid=prob.e_valid.at[5].set(False))
    got = tdist.partition_problem(_to_torch(prob), n_shards)
    want = jdist.partition_problem(prob, n_shards)
    for f in tba.BAProblem._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.points.shape[0] % n_shards == 0 and got.e_cam.shape[0] % n_shards == 0


@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_bundle_adjust_matches_reference(n_shards):
    """10% outliers, so that the chi2 gate from iteration 5 drops edges."""
    prob, _ = make_ba_problem(n_cams=6, n_pts=192, outlier_frac=0.1)
    probd_j = jdist.partition_problem(prob, n_shards)
    Rj, tj, pj, inl_j = jdist.dist_bundle_adjust(probd_j, jnp.asarray(CAM), _mesh(n_shards),
                                                 n_iters=8)
    probd = tdist.partition_problem(_to_torch(prob), n_shards)
    cam = torch.from_numpy(np.array(CAM))
    with reference_small_angle():
        Rt, tt, pt, inl_t = tdist.dist_bundle_adjust(
            probd, cam, tdist.DeviceMesh(["cpu"] * n_shards), n_iters=8)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-4)
    err = np.abs(pt.numpy() - np.asarray(pj)) / (1.0 + np.abs(np.asarray(pj)))
    assert err.max() <= 5e-5, err.max()
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert inl_t.numpy().mean() < 0.95
    # the port's own two solvers: the reference's tolerances between its own
    R1, t1, _, _ = tba.bundle_adjust(_to_torch(prob), cam, n_iters=8)
    Rd, td, _, _ = tdist.dist_bundle_adjust(probd, cam, tdist.DeviceMesh(["cpu"] * n_shards),
                                            n_iters=8)
    np.testing.assert_allclose(Rd.numpy(), R1.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(td.numpy(), t1.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_array_equal(Rd.numpy()[:2], np.asarray(prob.cam_R)[:2])


@pytest.fixture(scope="module")
def ring_map():
    arr, _, _ = ring_world()
    return arr


@pytest.mark.parametrize("n_shards", [2, 4])
def test_global_bundle_adjust_dist_matches_reference(ring_map, n_shards):
    cam = np.array([300.0, 300.0, 320.0, 200.0], np.float32)
    want = jmb.global_bundle_adjust_dist(
        jms.MapState(**{k: jnp.asarray(v) for k, v in ring_map.items()}), jnp.asarray(cam),
        _mesh(n_shards), bf=33.0, n_iters=10, chunk=5, n_ba_points=1024)
    polls = []
    with reference_small_angle():
        got = tmb.global_bundle_adjust_dist(
            tms.from_numpy(ring_map), torch.from_numpy(cam), tdist.DeviceMesh(["cpu"] * n_shards),
            bf=33.0, n_iters=10, chunk=5, n_ba_points=1024,
            should_abort=lambda: polls.append(1) or False)
    assert len(polls) == 2
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("mp_pos", 5e-4)):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=tol, err_msg=f)
    n = int(ring_map["n_kf"])
    np.testing.assert_array_equal(got.kf_t.numpy()[n:], ring_map["kf_t"][n:])
    np.testing.assert_array_equal(got.kf_t.numpy()[0], ring_map["kf_t"][0])
    assert np.abs(got.kf_t.numpy()[1:n] - ring_map["kf_t"][1:n]).max() > 1e-4


def test_global_bundle_adjust_dist_abort(ring_map):
    """An abort polled after the first chunk ends the schedule there, as the
    plain solver's: both leave the same map after one chunk."""
    cam = torch.tensor([300.0, 300.0, 320.0, 200.0])
    one = tmb.global_bundle_adjust_dist(tms.from_numpy(ring_map), cam,
                                        tdist.DeviceMesh(["cpu"] * 2), bf=33.0, n_iters=2,
                                        chunk=2, n_ba_points=1024)
    aborted = tmb.global_bundle_adjust_dist(tms.from_numpy(ring_map), cam,
                                            tdist.DeviceMesh(["cpu"] * 2), bf=33.0,
                                            n_iters=100, chunk=2, n_ba_points=1024,
                                            should_abort=lambda: True)
    for f in ("kf_R", "kf_t", "mp_pos"):
        assert torch.equal(getattr(one, f), getattr(aborted, f)), f


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_process_mesh_matches_device_mesh(tmp_path):
    """Two gloo ranks in spawned processes (JAX blocked in them), one
    all_reduce and one broadcast per iteration, against the same problem on
    a DeviceMesh of two CPU shards in this process."""
    prob, _ = make_ba_problem(n_cams=6, n_pts=192, outlier_frac=0.1)
    probd = tdist.partition_problem(_to_torch(prob), 2)
    src, out = str(tmp_path / "prob.npz"), str(tmp_path / "out.npz")
    np.savez(src, cam_params=np.array(CAM), n_iters=8,
             **{f: getattr(probd, f).numpy() for f in tba.BAProblem._fields})
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, WORKER, port, str(r), "2", src, out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    got = np.load(out)
    R, t, pts, inl = tdist.dist_bundle_adjust(probd, torch.from_numpy(np.array(CAM)),
                                              tdist.DeviceMesh(["cpu"] * 2), n_iters=8)
    for name, want in (("R", R), ("t", t), ("pts", pts)):
        np.testing.assert_allclose(got[name], want.numpy(), rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got["inl"], inl.numpy())


def test_auto_routing(ring_map, monkeypatch):
    """`global_bundle_adjust_auto`: on the CPU, or with one card, the plain
    solver; with more cards the sharded one over every card, the map's
    first (`gba_mesh`)."""
    assert tmb.gba_mesh(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmb.gba_mesh(torch.device("cuda:0")) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert [str(d) for d in tmb.gba_mesh(torch.device("cuda:1")).devices] == \
        ["cuda:1", "cuda:0", "cuda:2"]
    assert tmb.gba_mesh(torch.device("cpu")) is None

    cam = torch.tensor([300.0, 300.0, 320.0, 200.0])
    kw = dict(bf=33.0, n_iters=4, chunk=2, n_ba_points=1024)
    plain = tmb.global_bundle_adjust(tms.from_numpy(ring_map), cam, **kw)
    auto = tmb.global_bundle_adjust_auto(tms.from_numpy(ring_map), cam, **kw)
    assert torch.equal(auto.kf_R, plain.kf_R) and torch.equal(auto.mp_pos, plain.mp_pos)
    monkeypatch.setattr(tmb, "gba_mesh", lambda dev: tdist.DeviceMesh(["cpu"] * 2))
    sharded = tmb.global_bundle_adjust_dist(tms.from_numpy(ring_map), cam,
                                            tdist.DeviceMesh(["cpu"] * 2), **kw)
    auto = tmb.global_bundle_adjust_auto(tms.from_numpy(ring_map), cam, **kw)
    assert torch.equal(auto.kf_R, sharded.kf_R) and torch.equal(auto.mp_pos, sharded.mp_pos)
    assert not torch.equal(auto.mp_pos, plain.mp_pos)


def test_reference_dist_weighs_invalid_landmarks():
    """A reference fault the port repairs (ROADMAP queue 3): the reference's
    sharded BA weighs an edge of an invalid landmark into its camera (the
    global BA's window gathers such landmarks with a zero flag), its plain
    `bundle_adjust` does not, so its two solvers part on a real map. Here
    20 of 192 landmarks are invalid: the reference's two solvers part by
    more than 1e-3 in t; the port's agree within 1e-5 (f32 sums in another
    order), and with `torch_parity.reference_dist_edges` the port's sharded
    BA is the reference's again (1e-4)."""
    prob, _ = make_ba_problem(n_cams=6, n_pts=192)
    pt_valid = np.ones(192, bool)
    pt_valid[::10] = False
    prob = prob._replace(pt_valid=jnp.asarray(pt_valid))
    _, tj1, _, _ = jba.bundle_adjust(prob, jnp.asarray(CAM), n_iters=4)
    Rjd, tjd, _, _ = jdist.dist_bundle_adjust(jdist.partition_problem(prob, 2), jnp.asarray(CAM),
                                              _mesh(2), n_iters=4)
    assert np.abs(np.asarray(tjd) - np.asarray(tj1)).max() > 1e-3
    cam = torch.from_numpy(np.array(CAM))
    probd = tdist.partition_problem(_to_torch(prob), 2)
    with reference_small_angle():
        _, tt1, _, _ = tba.bundle_adjust(_to_torch(prob), cam, n_iters=4)
        _, ttd, _, _ = tdist.dist_bundle_adjust(probd, cam, tdist.DeviceMesh(["cpu"] * 2),
                                                n_iters=4)
        with reference_dist_edges():
            Rtr, ttr_, _, _ = tdist.dist_bundle_adjust(probd, cam, tdist.DeviceMesh(["cpu"] * 2),
                                                       n_iters=4)
    np.testing.assert_allclose(ttd.numpy(), tt1.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ttr_.numpy(), np.asarray(tjd), rtol=0, atol=1e-4)
    np.testing.assert_allclose(Rtr.numpy(), np.asarray(Rjd), rtol=0, atol=1e-4)
