"""RGB-D, the port against the JAX reference: both `System(cfg, "rgbd")`
through `track_rgbd` on the same frames of bench.py's room orbit at 320x200
(`torch_parity.orbit_frames`, the left images) with the same depth maps
(`io.synthetic.orbit_depth_maps`, the z-depth of the surface each pixel
shows), at `torch_parity.loop_config`, with the back end on and loop
closing off.

Held: the depth read at every keypoint equal, and its virtual right
coordinate u - bf / z equal wherever the two extractors' keypoint x is
(the reference reads both with numpy on the host, the port on the
device); a keypoint above level 0 can sit 1 ulp apart in the two
extractors (the reference's graph fuses (x + 0.5) * scale - 0.5), and its
coordinate then within 1e-5 px. The states, keyframe decisions and
landmark counts equal; the camera centres within 1e-4 m.

The reference's RGB-D path (`System._process_rgbd`, system.py:115-141)
calls the tracker's `_initialize_stereo` / `_track` itself and so skips
what `Tracker.process_frame` does around them. The port's RGB-D frames go
through `process_frame`, and each skipped step that changes a result is
shown on the reference (ROADMAP queue 3): no map compaction (a map whose
keyframe slots are used up makes no keyframe again), no timestamp guards
(a gap of over 1 s does not start a new map) and no map lock (a frame is
tracked while the mapper thread holds the map). The IMU's `_pre_frame`
reset it skips changes nothing without an IMU.

Also `CorridorWorld.depth` against an analytic case.
"""
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu import system as jsys  # noqa: E402
from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch import system as tsys  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import (CorridorWorld, StereoRig,  # noqa: E402
                                                orbit_depth_maps, ray_grid)
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import fast_reference_brief, loop_config, orbit_frames  # noqa: E402,F401
from torch_parity import reference_lie  # noqa: E402,F401

N_FRAMES = 30
MAX_KF = 12


@pytest.fixture(scope="module")
def sequence():
    imgs, ts, rig = orbit_frames(N_FRAMES)
    return imgs[:, 0], ts, orbit_depth_maps(N_FRAMES, rig), rig


def _observations(store):
    """Record the (u_r, depth) each tracker's initialisation and tracking
    receive."""
    mp = pytest.MonkeyPatch()
    for key, cls in (("j", jtr.Tracker), ("t", ttr.Tracker)):
        for name in ("_initialize_stereo", "_track"):
            real = getattr(cls, name)

            def wrapped(self, feats, u_r, depth, *a, _real=real, _key=key, **k):
                store[_key].append((np.asarray(u_r if _key == "j" else u_r.numpy()),
                                    np.asarray(depth if _key == "j" else depth.numpy()),
                                    np.asarray(feats.valid[0]), np.asarray(feats.xy[0])))
                return _real(self, feats, u_r, depth, *a, **k)
            mp.setattr(cls, name, wrapped)
    return mp


def _systems(cfg_fn, rig, **kw):
    js = jsys.System(cfg_fn(JCfg, rig), jsys.SENSOR_RGBD, enable_loop_closing=False, **kw)
    ts_ = tsys.System(cfg_fn(TCfg, rig), tsys.SENSOR_RGBD, enable_loop_closing=False,
                      device="cpu", **kw)
    return js, ts_


def _centre(tr, key):
    R, t = (np.asarray(x if key == "j" else x.numpy(), np.float64) for x in tr.pose)
    return -R.T @ t


@pytest.fixture(scope="module")
def runs(sequence, fast_reference_brief):
    imgs, ts, depths, rig = sequence
    obs = {"j": [], "t": []}
    out = {"j": [], "t": []}
    mp = _observations(obs)
    try:
        js, ts_ = _systems(loop_config, rig)
        for img, stamp, d in zip(imgs, ts, depths):
            for key, s in (("j", js), ("t", ts_)):
                res = s.track_rgbd(img, d, float(stamp))
                out[key].append(dict(res, c=_centre(s.tracker, key),
                                     n_mp=int(s.tracker.map.n_mp)))
    finally:
        mp.undo()
    return out, obs, js, ts_


def test_depth_and_virtual_right_equal(runs):
    _, obs, _, _ = runs
    assert len(obs["j"]) == len(obs["t"]) == N_FRAMES
    n_depth = 0
    for (uj, dj, vj, xj), (ut, dt, vt, xt) in zip(obs["j"], obs["t"]):
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(dt, dj)
        same_x = xt[:, 0] == xj[:, 0]
        assert same_x.mean() > 0.95
        np.testing.assert_array_equal(ut[same_x], uj[same_x])
        np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-5)
        n_depth += int((dj[vj] > 0).sum())
    assert n_depth > 100 * N_FRAMES


def test_systems_agree_frame_by_frame(runs):
    out, _, js, ts_ = runs
    assert [r["state"] for r in out["t"]] == [r["state"] for r in out["j"]]
    assert all(r["state"] == jtr.OK for r in out["j"])
    assert [r.get("kf") for r in out["t"]] == [r.get("kf") for r in out["j"]]
    assert [r["n_mp"] for r in out["t"]] == [r["n_mp"] for r in out["j"]]
    assert ts_.get_stats()["n_kf"] == js.get_stats()["n_kf"] >= 3
    err = max(np.linalg.norm(a["c"] - b["c"]) for a, b in zip(out["t"], out["j"]))
    assert err < 1e-4, err
    js.shutdown()
    ts_.shutdown()


def _dense_kf_config(cfg_cls, rig):
    """12 keyframe slots and a keyframe on every frame (phase C's policy)."""
    cfg = loop_config(cfg_cls, rig)
    cfg.map.max_kf = MAX_KF
    cfg.tracker.min_frames_between_kf = 1
    cfg.tracker.kf_ref_ratio = 10.0
    return cfg


def test_reference_rgbd_skips_compaction(sequence, fast_reference_brief):
    """With its keyframe slots used up, the reference's RGB-D System makes
    no keyframe again: the compaction that `process_frame` triggers never
    runs. The port's compacts and keeps making keyframes."""
    imgs, ts, depths, rig = sequence
    js, ts_ = _systems(_dense_kf_config, rig)
    for img, stamp, d in zip(imgs, ts, depths):
        js.track_rgbd(img, d, float(stamp))
        ts_.track_rgbd(img, d, float(stamp))
    assert js.get_stats()["n_kf"] == MAX_KF - 1 == int(js.tracker.map.n_kf)
    assert ts_.get_stats()["n_compactions"] >= 1
    assert ts_.get_stats()["n_kf"] > MAX_KF
    assert js.get_tracking_state() == ts_.get_tracking_state() == jtr.OK


def test_reference_rgbd_ignores_a_stamp_gap(sequence, fast_reference_brief):
    """A gap of 2 s in the stamps: the reference's RGB-D System goes on in
    its map; the port's, as its stereo and mono paths (Tracking.cc:1871),
    gives the small map up and initialises a new one on that frame."""
    imgs, ts, depths, rig = sequence
    js, ts_ = _systems(loop_config, rig)
    for i in range(8):
        stamp = float(ts[i]) + (2.0 if i >= 6 else 0.0)
        js.track_rgbd(imgs[i], depths[i], stamp)
        ts_.track_rgbd(imgs[i], depths[i], stamp)
    assert js.get_stats()["n_resets"] == 0 and js.get_stats()["n_new_maps"] == 0
    assert ts_.get_stats()["n_resets"] == 1
    assert js.get_tracking_state() == ts_.get_tracking_state() == jtr.OK


@pytest.mark.parametrize("package", ["reference", "port"])
def test_rgbd_frame_and_the_map_lock(sequence, fast_reference_brief, package):
    """While another thread holds the tracker's map lock (the mapper thread
    holds it through a keyframe's back end), the reference's `track_rgbd`
    tracks the frame anyway; the port's waits for the lock."""
    imgs, ts, depths, rig = sequence
    mod, cfg_cls = (jsys, JCfg) if package == "reference" else (tsys, TCfg)
    kw = {} if package == "reference" else {"device": "cpu"}
    s = mod.System(loop_config(cfg_cls, rig), mod.SENSOR_RGBD, enable_loop_closing=False,
                   **kw)
    s.track_rgbd(imgs[0], depths[0], float(ts[0]))
    s.track_rgbd(imgs[1], depths[1], float(ts[1]))      # compiled, tracking
    done = threading.Event()
    worker = threading.Thread(
        target=lambda: (s.track_rgbd(imgs[2], depths[2], float(ts[2])), done.set()))
    with s.tracker._map_lock:
        worker.start()
        tracked_while_held = done.wait(timeout=20.0 if package == "reference" else 2.0)
    worker.join(timeout=60.0)
    assert done.is_set()
    assert tracked_while_held == (package == "reference")
    assert s.tracker.stats["n_frames"] == 3


def test_rgbd_input_checks(sequence):
    imgs, ts, depths, rig = sequence
    s = tsys.System(loop_config(TCfg, rig), tsys.SENSOR_RGBD, device="cpu")
    with pytest.raises(ValueError, match="depth map"):
        s.track_rgbd(imgs[0], depths[0][:10], float(ts[0]))
    with pytest.raises(ValueError, match="rgbd"):
        s.track_stereo(np.stack([imgs[0], imgs[0]]), float(ts[0]))
    with pytest.raises(ValueError, match="rgbd"):
        s.tracker.process_frame(imgs[0], float(ts[0]))
    s.track_rgbd(torch.from_numpy(imgs[0]), torch.from_numpy(depths[0]), float(ts[0]))
    assert s.get_tracking_state() == jtr.OK


def test_corridor_depth_analytic():
    """The camera at the room's centre (0, 0, 0.5) facing the end wall
    z = 4 reads 3.5 wherever it sees that wall, the floor's depth at row v
    is half_h fy / (v - cy), and every pixel's point lies on a plane of the
    room; no pixel is without a surface in the closed room."""
    rig = StereoRig()
    world = CorridorWorld(half_w=4.0, half_h=1.5, z0=-4.0, z1=4.0, back_wall=True)
    c = np.array([0.0, 0.0, 0.5], np.float32)
    d = world.depth(np.eye(3, dtype=np.float32), c, rig)
    assert d.shape == (rig.height, rig.width) and d.dtype == np.float32
    assert (d > 0).all()
    assert d[200, 320] == np.float32(3.5)
    p = ray_grid(rig) * d[..., None] + c
    on_wall = np.isclose(p[..., 2], 4.0, atol=1e-5)
    assert on_wall.sum() > 0.3 * d.size
    np.testing.assert_allclose(d[on_wall], 3.5, rtol=0, atol=1e-6)
    v = 390
    np.testing.assert_allclose(d[v, 320], 1.5 * rig.fy / (v - rig.cy), rtol=1e-6)
    on_plane = (np.isclose(np.abs(p[..., 0]), 4.0, atol=1e-4)
                | np.isclose(np.abs(p[..., 1]), 1.5, atol=1e-4)
                | np.isclose(np.abs(p[..., 2]), 4.0, atol=1e-4))
    assert on_plane.all()
