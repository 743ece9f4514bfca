"""Monocular-inertial SLAM past its IMU initialisation, the port against the
JAX reference on the CPU.

The sequence is chip_smoke.py's phase J at tests/test_torch_mono.py's
configuration (640x400, 384 keypoints): the seed-5 corridor driven at SPEED
m/s with a lateral sway of WIGGLE m (`io.synthetic.render_corridor_mono`),
its IMU from `corridor_imu_stream(speed=, wiggle=)` with cfg.imu's noise
and phase I's constant biases. At phase I's 0.8 m/s and 0.25 m the scale
cannot be observed and every attempt falls under the reference's s < 0.1
guard (tests/test_torch_imu_slam.py); here the IMU initialises. Both
trackers run on the reference's RANSAC draws and the reference's Lie
arithmetic (`reference_lie`), with the port's median-depth repair put into
the reference (`torch_parity.reference_median_depth`, as chip_smoke's
bounds come from `tools/reference_smoke.py --median-depth`): the
reference's own initial map keeps the two-view baseline, a few
centimetres here, as its unit, and its guard then drops every attempt,
however good its scale.

Frame by frame over N_FRAMES frames, through the IMU initialisation and the
VI windows after it: states, inlier counts, keyframe decisions and
`imu_ready` equal on every frame; every initialisation attempt's keyframe
count equal, its scale within 1e-3 and its biases within 1e-4; camera
centres within 2e-3 (the map's units: the two-view baseline before the
initialisation, metres after it); the initialisation's `transform_map`
with the same scale within 1e-4 relative.

Solve by solve, both trackers from the reference's final state (its map,
bias and preintegrations copied into the port): VIBA (`_run_full_inertial_ba`:
visual BA and the VI pass over the monocular map's chain) and the scale
refinement (`_refine_scale`), on the map as it is (where the reference's
gate makes it a no-op) and on the map grown by a known factor, which the
refinement must undo.
"""
import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.models import atlas as jatlas  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import (StereoRig, corridor_imu_stream,  # noqa: E402
                                                render_corridor_mono,
                                                render_stereo_sequence)
from orbslam3lib_tpu_torch.models import atlas as tatlas  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402
from orbslam3lib_tpu_torch.tracking import imu as timu  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import fast_reference_brief, reference_ransac_draws  # noqa: E402,F401
from torch_parity import reference_lie, reference_median_depth  # noqa: E402,F401
from test_torch_mono import corridor_config  # noqa: E402

SPEED, WIGGLE = 2.0, 1.2             # chip_smoke.py's IMU_MONO_SPEED, IMU_MONO_WIGGLE
N_FRAMES = 36
IMU_BG = (0.002, -0.001, 0.0015)     # chip_smoke.py's phase I biases
IMU_BA = (0.02, -0.01, 0.015)


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)


@contextlib.contextmanager
def inertial_solves(store):
    """Record every inertial initialisation solve of both packages (the
    initialisation's attempts and the scale refinements): the frame, the
    keyframes of its window, whether the IMU was ready, scale and biases;
    and every `transform_map` the trackers make (its rotation and scale)."""
    real = {"j": jtr.inertial_init_optimization, "t": ttr.inertial_init_optimization}
    real_tf = {"j": jtr.transform_map, "t": ttr.transform_map}

    def logged(key, tracker_of):
        def f(kf_R, *a, **k):
            out = real[key](kf_R, *a, **k)
            store.setdefault(key, []).append(dict(
                frame=store["frame"], n_kf=int(kf_R.shape[0]), ready=tracker_of().imu_ready,
                s=float(_host(out[3])), bg=_host(out[1]), ba=_host(out[2])))
            return out
        return f

    def transformed(key):
        def f(m, R, t, s):
            store.setdefault(key + "_tf", []).append((store["frame"], _host(R), float(_host(s))))
            return real_tf[key](m, R, t, s)
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "inertial_init_optimization", logged("j", lambda: store["jt"]))
        mp.setattr(ttr, "inertial_init_optimization", logged("t", lambda: store["tt"]))
        mp.setattr(jtr, "transform_map", transformed("j"))
        mp.setattr(ttr, "transform_map", transformed("t"))
        yield


def make_trackers(rig):
    cfgs = []
    for cfg_cls in (JCfg, TCfg):
        cfg = corridor_config(cfg_cls, rig)
        cfg.use_imu = True
        cfgs.append(cfg)
    return (jtr.Tracker(cfgs[0], "mono", enable_loop_closing=False),
            ttr.Tracker(cfgs[1], "mono", enable_loop_closing=False, device="cpu"))


@pytest.fixture(scope="module")
def corridor():
    imgs, ts, rig = render_corridor_mono(N_FRAMES, seed=5, speed=SPEED, wiggle=WIGGLE)
    ci = TCfg().imu
    imu = corridor_imu_stream(ts, ci.noise_gyro, ci.noise_acc, ci.freq, IMU_BG, IMU_BA,
                              seed=0, speed=SPEED, wiggle=WIGGLE)
    return imgs, ts, rig, imu


@pytest.fixture(scope="module")
def runs(corridor, fast_reference_brief):
    """Both trackers frame by frame; per-frame records (state, inliers,
    keyframe, imu_ready, camera centre, bias) and the inertial solves."""
    imgs, ts, rig, imu = corridor
    jt, tt = make_trackers(rig)
    store = {"jt": jt, "tt": tt, "frame": 0}
    recs = ([], [])
    with reference_ransac_draws(), reference_median_depth(), inertial_solves(store):
        for i in range(N_FRAMES):
            store["frame"] = i
            for tr, rec in zip((jt, tt), recs):
                if imu[i] is not None:
                    tr.feed_imu(*imu[i])
                out = tr.process_frame(imgs[i], float(ts[i]))
                c = None
                if tr.pose is not None:
                    R, t = (_host(x) for x in tr.pose)
                    c = -R.T @ t
                rec.append(dict(state=int(out["state"]), n=int(out["n_inliers"]),
                                kf=bool(out.get("kf", False)), imu=bool(tr.imu_ready), c=c,
                                bias=[_host(b) for b in tr.imu_bias]))
    return jt, tt, recs, store


def test_corridor_mono_is_the_stereo_sequences_left_camera():
    """At the default speed and sway `render_corridor_mono` gives
    `render_stereo_sequence`'s left images and stamps (the right image's
    noise is drawn, not rendered), so phase J's sequence is the corridor's
    noise stream at another speed."""
    rig = StereoRig(width=96, height=64, fx=60.0, fy=60.0, cx=48.0, cy=32.0)
    imgs, ts, _ = render_corridor_mono(3, rig, seed=5)
    frames, _, _ = render_stereo_sequence(3, rig, seed=5)
    np.testing.assert_array_equal(imgs, np.stack([f[0][0] for f in frames]))
    np.testing.assert_array_equal(ts, [f[2] for f in frames])


def test_states_inliers_keyframes_and_imu_flag_agree(runs):
    jt, tt, (jr, tr), _ = runs
    for i, (a, b) in enumerate(zip(jr, tr)):
        assert (a["state"], a["n"], a["kf"], a["imu"]) == (b["state"], b["n"], b["kf"], b["imu"]), i
    init = next(i for i, r in enumerate(jr) if r["imu"])
    # the VI windows after the initialisation: one on every keyframe since
    assert sum(r["kf"] for r in jr[init + 1:]) >= 2
    assert all(r["state"] == jtr.OK for r in jr[init:])
    assert tt.stats["n_kf"] == jt.stats["n_kf"]
    assert tt.stats["track_fail"] == jt.stats["track_fail"]
    assert len(tt._kf_preints) == len(jt._kf_preints)
    assert sorted(tt._gap_by_dst) == sorted(jt._gap_by_dst)


def test_initialisation_attempts_agree(runs):
    """Each attempt's window, scale (1e-3) and biases (1e-4) as the
    reference's; the attempts before the last fell under the 0.1 guard and
    the last passed it, in both."""
    _, _, _, store = runs
    js = [x for x in store["j"] if not x["ready"]]
    ts_ = [x for x in store["t"] if not x["ready"]]
    assert len(js) == len(ts_) >= 1
    for a, b in zip(js, ts_):
        assert (a["frame"], a["n_kf"]) == (b["frame"], b["n_kf"])
        assert abs(a["s"] - b["s"]) < 1e-3, (a["frame"], a["s"], b["s"])
        np.testing.assert_allclose(b["bg"], a["bg"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(b["ba"], a["ba"], rtol=0, atol=1e-4)
    assert all(x["s"] < 0.1 for x in js[:-1]) and js[-1]["s"] >= 0.1
    assert all(x["s"] < 0.1 for x in ts_[:-1]) and ts_[-1]["s"] >= 0.1


def test_camera_centres_and_biases_agree(runs):
    _, _, (jr, tr), _ = runs
    for i, (a, b) in enumerate(zip(jr, tr)):
        if a["c"] is not None:
            np.testing.assert_allclose(b["c"], a["c"], rtol=0, atol=2e-3, err_msg=f"c {i}")
        for x, y in zip(b["bias"], a["bias"]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-4, err_msg=f"bias {i}")


def test_initialisation_transform_agrees(runs):
    """The map's move into the gravity frame at the IMU initialisation: the
    same frame, rotation within 1e-4 and scale within 1e-4 relative; and
    the port's `transform_map` on the reference's final map with the
    reference's rotation and scale gives the reference's result (1e-5 of
    its extent)."""
    jt, _, _, store = runs
    (fj, Rj, sj), (ft, Rt, st) = store["j_tf"][0], store["t_tf"][0]
    assert fj == ft
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-4)
    assert abs(st - sj) <= 1e-4 * sj, (st, sj)
    m = jt.map
    out_j = jatlas.transform_map(m, jnp.asarray(Rj, jnp.float32), jnp.zeros(3), jnp.float32(sj))
    out_t = tatlas.transform_map(tms.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()}),
                                 torch.tensor(Rj, dtype=torch.float32), torch.zeros(3), sj)
    extent = float(np.abs(np.asarray(out_j.kf_t)).max())
    for f in ("kf_R", "kf_t", "mp_pos", "kf_v"):
        np.testing.assert_allclose(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)),
                                   rtol=0, atol=1e-5 * max(extent, 1.0), err_msg=f)


# -- solve by solve, from the reference's final state -------------------------

@pytest.fixture
def same_state(runs):
    """The reference's final tracker state (map, bias, preintegrations,
    pose, velocity) copied into the port's tracker; the reference's restored
    after the test."""
    jt, tt, _, _ = runs
    saved = (jt.map, jt.imu_bias, jt.pose, jt.frame_state_v, jt.anchor_state)
    tt.map = tms.from_numpy({k: np.asarray(v) for k, v in jt.map._asdict().items()})
    tt.imu_bias = tuple(torch.from_numpy(np.array(b, np.float32)) for b in jt.imu_bias)
    tt._kf_preints = [timu.Preintegrated.from_arrays(p) for p in jt._kf_preints]
    tt._gap_by_dst = {k: (src, timu.Preintegrated.from_arrays(p))
                      for k, (src, p) in jt._gap_by_dst.items()}
    tt.pose = tuple(torch.from_numpy(np.array(x, np.float32)) for x in jt.pose)
    assert tt._n_kf_host == int(jt.map.n_kf) and tt.last_kf_id == jt.last_kf_id
    yield jt, tt
    jt.map, jt.imu_bias, jt.pose, jt.frame_state_v, jt.anchor_state = saved


def _assert_maps_agree(mt, mj, tols):
    n = int(mj.n_kf)
    for f, tol in tols.items():
        np.testing.assert_allclose(getattr(mt, f)[:n].numpy(), np.asarray(getattr(mj, f))[:n],
                                   rtol=0, atol=tol, err_msg=f)


def test_full_inertial_ba_on_the_monocular_map(same_state):
    """VIBA1 / VIBA2's solve on the monocular map: two rounds of the
    visual BA over the last 24 keyframes and the VI pass over the chain.
    Poses 1e-4 (rotation entries, metres), velocities 1e-3 m/s, biases
    1e-4, as tests/test_torch_vi_ba.py holds one window."""
    jt, tt = same_state
    kid = jt.last_kf_id
    jt._run_full_inertial_ba(kid)
    tt._run_full_inertial_ba(kid)
    _assert_maps_agree(tt.map, jt.map, {"kf_R": 1e-4, "kf_t": 1e-4, "kf_v": 1e-3,
                                        "kf_bg": 1e-4, "kf_ba": 1e-4})
    for x, y in zip(tt.imu_bias, jt.imu_bias):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-4)


@pytest.mark.parametrize("grow", [1.0, 3.0])
def test_scale_refinement(same_state, grow):
    """`_refine_scale` on the final map, and on it grown by `grow` in both
    packages first: the refined scale within 1e-3 relative of the
    reference's and the biases within 1e-4. The initialisation left this
    map about 4 times too small (its scale read 0.47 where the corridor's
    median depth is ~3 m), so on the map as it is the refinement's scale
    falls outside the reference's (0.5, 2) gate (reference :2187) and both
    leave the map as it was. Grown by 3 the scale is inside it: both apply
    it (the maps after within 1e-4, rotation entries and metres), and it is
    the ungrown map's / 3 within 1%."""
    jt, tt = same_state
    store = {"frame": -1, "jt": jt, "tt": tt}
    if grow != 1.0:
        with inertial_solves(store):
            jt._refine_scale()
        s_as_is = store.pop("j")[0]["s"]
        jt.map = jatlas.transform_map(jt.map, jnp.eye(3, dtype=jnp.float32), jnp.zeros(3),
                                      jnp.float32(grow))
        tt.map = tatlas.transform_map(tt.map, torch.eye(3), torch.zeros(3), grow)
    before = {f: getattr(tt.map, f).clone() for f in ("kf_R", "kf_t", "mp_pos")}
    with inertial_solves(store):
        jt._refine_scale()
        tt._refine_scale()
    sj, st = store["j"][0]["s"], store["t"][0]["s"]
    assert abs(st - sj) <= 1e-3 * sj, (st, sj)
    for x, y in zip(tt.imu_bias, jt.imu_bias):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-4)
    if grow == 1.0:
        assert not 0.5 < sj < 2.0 and "j_tf" not in store and "t_tf" not in store
        assert all(torch.equal(getattr(tt.map, f), v) for f, v in before.items())
        return
    assert 0.5 < sj < 2.0 and len(store["j_tf"]) == len(store["t_tf"]) == 1
    assert abs(sj * grow - s_as_is) <= 0.01 * s_as_is, (sj, s_as_is)
    _assert_maps_agree(tt.map, jt.map, {"kf_R": 1e-4, "kf_t": 1e-4, "mp_pos": 1e-4})
