"""Visual-inertial SLAM, the port against the JAX reference on the CPU.

Both trackers run frame by frame on tests/test_slam_modes.py's 40-frame
corridor (640x400, 384 keypoints; `TestStereoInertial`'s configuration)
with `cfg.use_imu`, fed the same IMU: `io.synthetic.corridor_imu_stream`
at 200 Hz with cfg.imu's noise and the constant biases of chip_smoke's
phase I. Held: every frame's state and keyframe decision, the IMU
initialisation frame, the inliers (within 2), the bias estimates (1e-4, or
5e-3 on a frame whose inliers differ) and the camera poses (1e-4 in
rotation entries and metres; see `assert_frames_agree`). The
monocular-inertial tracker is held through its initialisation attempts
(the reference's RANSAC draws and its median-depth fault put back, as
tests/test_torch_mono.py does; poses 2e-3 of the scene's scale, as there).

The guard rails of tests/test_guard_rails.py on both packages: keyframes
inserted while RECENTLY_LOST on the IMU's prediction with
`insert_kfs_when_lost` on and off, and the bad-IMU flag with its reset at
the next frame.
"""
import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.ops.extractor import Features as JFeatures  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import (corridor_imu_stream,  # noqa: E402
                                                render_stereo_sequence)
from orbslam3lib_tpu_torch.ops.extractor import Features as TFeatures  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import fast_reference_brief, reference_ransac_draws  # noqa: E402,F401
from test_torch_mono import corridor_config  # noqa: E402
from torch_parity import reference_median_fault  # noqa: E402
from torch_parity import reference_lie  # noqa: E402,F401

IMU_BG = (0.002, -0.001, 0.0015)     # chip_smoke.py's phase I biases
IMU_BA = (0.02, -0.01, 0.015)


@pytest.fixture(scope="module")
def corridor():
    frames, rig, _ = render_stereo_sequence(40, seed=5)
    ts = np.array([f[2] for f in frames])
    ci = TCfg().imu
    imu = corridor_imu_stream(ts, ci.noise_gyro, ci.noise_acc, ci.freq, IMU_BG, IMU_BA, seed=0)
    return frames, rig, imu


def run_pair(corridor, sensor: str, n: int):
    """Both trackers with the IMU over the first n frames; per-frame records
    (state, inliers, keyframe, imu_ready, R, t, bias) of each."""
    frames, rig, imu = corridor
    trackers = []
    for cfg_cls, make in ((JCfg, lambda c: jtr.Tracker(c, sensor, enable_loop_closing=False)),
                          (TCfg, lambda c: ttr.Tracker(c, sensor, enable_loop_closing=False,
                                                       device="cpu"))):
        cfg = corridor_config(cfg_cls, rig)
        cfg.use_imu = True
        trackers.append(make(cfg))
    recs = ([], [])
    for i in range(n):
        pair, _, ts = frames[i]
        img = pair if sensor == "stereo" else pair[0]
        for tr, rec in zip(trackers, recs):
            if imu[i] is not None:
                tr.feed_imu(*imu[i])
            out = tr.process_frame(img, ts)
            R, t = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)
                    for x in tr.pose) if tr.pose is not None else (None, None)
            rec.append(dict(state=int(out["state"]), n=int(out["n_inliers"]),
                            kf=bool(out.get("kf", False)), imu=bool(tr.imu_ready), R=R, t=t,
                            bias=[np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
                                  for b in tr.imu_bias]))
    return trackers, recs


def assert_frames_agree(recs, pose_tol: float):
    """States, keyframe decisions and the IMU flag equal on every frame;
    inliers within 2 (one observation at a chi2 gate flips in f32: frame 38
    reads 113 in the reference and 114 here); poses within pose_tol; the
    bias estimates within 1e-4, 5e-3 on a frame whose inlier count differs
    (one frame's solve pins the bias weakly: frame 38's moved 1.7e-3 with
    that observation, and frame 39 agrees to 3e-6 again)."""
    jr, tr = recs
    for i, (a, b) in enumerate(zip(jr, tr)):
        assert (a["state"], a["kf"], a["imu"]) == (b["state"], b["kf"], b["imu"]), i
        assert abs(a["n"] - b["n"]) <= 2, (i, a["n"], b["n"])
        if a["R"] is not None:
            np.testing.assert_allclose(b["R"], a["R"], rtol=0, atol=pose_tol, err_msg=f"R {i}")
            np.testing.assert_allclose(b["t"], a["t"], rtol=0, atol=pose_tol, err_msg=f"t {i}")
        for x, y in zip(b["bias"], a["bias"]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-4 if a["n"] == b["n"] else 5e-3,
                                       err_msg=f"bias {i}")


def test_stereo_inertial_trackers_agree(corridor, fast_reference_brief):
    (jt, tt), recs = run_pair(corridor, "stereo", 40)
    assert_frames_agree(recs, 1e-4)
    init = [next(i for i, r in enumerate(rec) if r["imu"]) for rec in recs]
    assert init[0] == init[1] < 39
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 0
    assert tt.stats["n_kf"] == jt.stats["n_kf"]
    # the port's VI windows ran on the CPU's torch path
    assert tt.stats["vi_evals_torch"] > 0 == tt.stats["vi_evals_fused"]
    assert len(tt._kf_preints) == len(jt._kf_preints)
    assert sorted(tt._gap_by_dst) == sorted(jt._gap_by_dst)
    assert tt.loop_closer is None and jt.loop_closer is None
    # the keyframes' stored velocities and biases
    n = int(tt.map.n_kf)
    for f in ("kf_v", "kf_bg", "kf_ba"):
        np.testing.assert_allclose(getattr(tt.map, f)[:n].numpy(),
                                   np.asarray(getattr(jt.map, f))[:n], rtol=0, atol=1e-3,
                                   err_msg=f)


@contextlib.contextmanager
def init_attempts(store):
    """Record every inertial initialisation solve of both packages: the
    keyframe count of its window and its scale and biases."""
    real = {"j": jtr.inertial_init_optimization, "t": ttr.inertial_init_optimization}

    def logged(key):
        def f(kf_R, *a, **k):
            out = real[key](kf_R, *a, **k)
            store.setdefault(key, []).append(
                (int(kf_R.shape[0]), float(np.asarray(out[3])),
                 np.asarray(out[1]), np.asarray(out[2])))
            return out
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "inertial_init_optimization", logged("j"))
        mp.setattr(ttr, "inertial_init_optimization", logged("t"))
        yield


def test_mono_inertial_through_initialisation(corridor, fast_reference_brief):
    """Monocular-inertial on the corridor: both trackers make the same
    frames, keyframes and initialisation attempts. The reference never
    initialises the IMU here (ROADMAP queue 3): from the 7th keyframe on
    every attempt's scale comes out near 0.001-0.005 and the s < 0.1 guard
    aborts it, the corridor's near-constant velocity leaving the scale
    unobservable; the port's attempts are held to the reference's (scale
    1e-3 absolute, biases 1e-4)."""
    store = {}
    with reference_ransac_draws(), reference_median_fault(), init_attempts(store):
        (jt, tt), recs = run_pair(corridor, "mono", 40)
    jr, tr = recs
    for i, (a, b) in enumerate(zip(jr, tr)):
        assert (a["state"], a["n"], a["kf"], a["imu"]) == (b["state"], b["n"], b["kf"], b["imu"]), i
        if a["t"] is not None:
            np.testing.assert_allclose(b["t"], a["t"], rtol=0, atol=2e-3, err_msg=f"t {i}")
    assert len(store["j"]) == len(store["t"]) >= 3
    for (kj, sj, bgj, baj), (kt, st, bgt, bat) in zip(store["j"], store["t"]):
        assert kj == kt
        assert abs(sj - st) < 1e-3 and sj < 0.1
        np.testing.assert_allclose(bgt, bgj, rtol=0, atol=1e-4)
        np.testing.assert_allclose(bat, baj, rtol=0, atol=1e-4)
    assert not jt.imu_ready and not tt.imu_ready
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 0


# -- the guard rails (tests/test_guard_rails.py) ------------------------------

def _small_cfg(cfg_cls):
    cfg = cfg_cls()
    cfg.camera.width, cfg.camera.height = 128, 96
    cfg.camera.fx = cfg.camera.fy = 80.0
    cfg.camera.cx, cfg.camera.cy = 64.0, 48.0
    cfg.orb.max_kp = 64
    cfg.orb.n_levels = 2
    cfg.map.max_kf = 32
    cfg.map.max_mp = 512
    cfg.use_imu = True
    return cfg


def _fake_feats(F=64, seed=0):
    rng = np.random.default_rng(seed)
    a = dict(xy=rng.uniform([2, 2], [126, 94], (F, 2)).astype(np.float32),
             level=np.zeros(F, np.int32), score=np.ones(F, np.float32),
             angle=np.zeros(F, np.float32),
             desc=rng.integers(0, 2, (F, 256)).astype(np.int8), valid=np.ones(F, bool))
    j = JFeatures(**{k: jnp.stack([jnp.asarray(v)] * 2) for k, v in a.items()})
    t = TFeatures(**{k: torch.stack([torch.as_tensor(v)] * 2) for k, v in a.items()})
    return j, t


def _lost_trackers(flag: bool):
    """Both packages' stereo-inertial trackers with one keyframe at t = 0 and
    the IMU marked initialised (tests/test_guard_rails.py's set-up)."""
    out = []
    fj, ft = _fake_feats()
    for cfg_cls, feats, xp, make in (
            (JCfg, fj, jnp, lambda c: jtr.Tracker(c, "stereo", enable_loop_closing=False)),
            (TCfg, ft, torch, lambda c: ttr.Tracker(c, "stereo", enable_loop_closing=False,
                                                    device="cpu"))):
        cfg = _small_cfg(cfg_cls)
        cfg.tracker.insert_kfs_when_lost = flag
        tr = make(cfg)
        F = cfg.orb.max_kp
        depth = xp.asarray(np.full(F, 5.0, np.float32))
        if xp is torch:
            tr._ensure_place_rec(feats.desc[0])
        tr.state = jtr.OK
        eye = np.eye(3, dtype=np.float32)
        tr.pose = (xp.asarray(eye), xp.asarray(np.zeros(3, np.float32)))
        tr.vel = (xp.asarray(eye), xp.asarray(np.zeros(3, np.float32)))
        tr._create_keyframe(feats, xp.asarray(np.zeros(F, np.float32)), depth,
                            xp.asarray(np.full(cfg.map.max_mp, -1, np.int32)), 0.0, 50)
        tr.imu_ready = True
        out.append((tr, feats, depth, xp))
    return out


@pytest.mark.parametrize("flag", [True, False])
def test_keyframes_inserted_while_lost(flag):
    """RECENTLY_LOST with a live IMU: the IMU-predicted pose stands in, and
    with the flag a keyframe bridges the gap 0.6 s after the last one. (The
    port's keyframe database exists from the first keyframe on; the
    reference's is not made in this set-up, so the lost frame is one that
    cannot relocalise against the keyframe.)"""
    got = []
    lost = _fake_feats(seed=1)   # a frame unlike the keyframe: no relocalisation
    for (tr, feats, depth, xp), feats in zip(_lost_trackers(flag), lost):
        n0 = tr.stats["n_kf"]
        F = feats.xy.shape[-2]
        pred = (xp.asarray(np.eye(3, dtype=np.float32)),
                xp.asarray(np.array([0.1, 0.0, 0.0], np.float32)))
        out = tr._handle_loss(feats, 0.6, u_r=xp.asarray(np.zeros(F, np.float32)),
                              depth=depth, pred_pose=pred)
        assert out["state"] == jtr.RECENTLY_LOST
        assert float(tr.pose[1][0]) == pytest.approx(0.1)
        got.append((tr.stats["n_kf"] - n0, int(tr.map.n_kf), list(tr._kf_times),
                    sorted(tr._gap_by_dst)))
    assert got[0] == got[1]
    assert got[0][0] == (1 if flag else 0)


@pytest.mark.parametrize("moved", [False, True])
def test_bad_imu_flag_and_reset(moved):
    """Less than 2 cm over the last two keyframe gaps within 10 s of the IMU
    initialisation flags the IMU bad, and the next frame resets the map;
    with motion nothing is flagged."""
    for cfg_cls, make, xp in (
            (JCfg, lambda c: jtr.Tracker(c, "stereo", enable_loop_closing=False), jnp),
            (TCfg, lambda c: ttr.Tracker(c, "stereo", enable_loop_closing=False,
                                         device="cpu"), torch)):
        cfg = _small_cfg(cfg_cls)
        tr = make(cfg)
        tr.imu_ready = True
        tr._viba_stage = 0
        tr._imu_init_ts = 0.0
        tr._kf_times = [0.0, 0.25, 0.5]
        c = np.zeros(3)
        step = np.array([0.1, 0, 0]) if moved else np.full(3, 1e-4)
        tr._kf_centers = [c, c + step, c + 2 * step]
        tr._check_bad_imu()
        assert tr._bad_imu == (not moved)
        if moved:
            continue
        tr.state = jtr.OK
        eye = np.eye(3, dtype=np.float32)
        tr.pose = (xp.asarray(eye), xp.asarray(np.zeros(3, np.float32)))
        n_resets = tr.stats["n_resets"]
        img = np.zeros((2, cfg.camera.height, cfg.camera.width), np.float32)
        tr.process_frame(img, 1.0)
        assert tr.stats["n_resets"] == n_resets + 1
        assert not tr._bad_imu and not tr.imu_ready
