"""The port's public API (`orbslam3lib_tpu_torch.system.System`) against the
JAX reference's `System`, as tests/test_system_io.py::TestSystem::
test_sync_stereo_pipeline drives it: the first 20 frames of its corridor
sequence through `track_stereo`, then the TUM and KITTI trajectory files,
whose numbers agree to 1e-5 line by line. Also: the pipeline's backpressure
(a queue of depth 2 that drops frames while the consumer is busy) drops
the same frames in both; the sensors and options not ported raise
NotImplementedError; the PNG writer, the map render and the PLY export
give the same bytes as the reference's `viz` for the same map arrays."""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu import system as jsys, viz as jviz  # noqa: E402
from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu_torch import system as tsys, viz as tviz  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import render_stereo_sequence  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402
from orbslam3lib_tpu_torch.tracking.tracker import OK  # noqa: E402

from torch_parity import fast_reference_brief  # noqa: E402,F401


def small_cfg(cfg_cls, rig):
    """tests/test_system_io.py's configuration."""
    cfg = cfg_cls()
    cfg.map.max_kf = 64
    cfg.map.max_mp = 4096
    cfg.orb.max_kp = 384
    cfg.orb.target_features = 300
    cfg.orb.fast_threshold = 12.0
    cfg.tracker.min_init_features = 150
    cfg.ba.max_points = 1024
    cfg.ba.window_size = 6
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    return cfg


@pytest.fixture(scope="module")
def sequence():
    return render_stereo_sequence(n_frames=20, dt=1.0 / 15.0, seed=5)


@pytest.fixture(scope="module")
def systems(sequence, fast_reference_brief, tmp_path_factory):
    frames, rig, _ = sequence
    js = jsys.System(small_cfg(JCfg, rig), jsys.SENSOR_STEREO, enable_loop_closing=False)
    ts_ = tsys.System(small_cfg(TCfg, rig), tsys.SENSOR_STEREO, enable_loop_closing=False,
                      device="cpu")
    for img_pair, _, stamp in frames:
        js.track_stereo(img_pair, stamp)
        ts_.track_stereo(img_pair, stamp)
    out = tmp_path_factory.mktemp("traj")
    files = {}
    for name, s in (("j", js), ("t", ts_)):
        files[name, "tum"] = str(out / f"{name}_tum.txt")
        files[name, "kitti"] = str(out / f"{name}_kitti.txt")
        s.save_trajectory_tum(files[name, "tum"])
        s.save_trajectory_kitti(files[name, "kitti"])
        s.shutdown()
    return js, ts_, files, len(frames)


def test_sync_stereo_pipeline(systems):
    js, ts_, _, _ = systems
    assert ts_.get_tracking_state() == js.get_tracking_state() == OK
    assert not ts_.is_lost()
    ti, ji = ts_.map_info(), js.map_info()
    assert (ti["n_kf"], ti["n_mp"]) == (ji["n_kf"], ji["n_mp"])
    assert ti["n_kf"] >= 2 and ti["n_mp"] > 100
    assert ti["n_maps"] == 1 and ti["n_new_maps"] == 0
    for k in ("n_kf", "n_frames", "track_fail", "n_loops"):
        assert ts_.get_stats()[k] == js.get_stats()[k]


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_trajectory_files_agree(systems, fmt):
    _, _, files, n = systems
    lines = {k: open(files[k, fmt]).read().strip().splitlines() for k in ("j", "t")}
    assert len(lines["t"]) == len(lines["j"]) == n
    assert len(lines["t"][0].split()) == (8 if fmt == "tum" else 12)
    a = np.array([[float(x) for x in ln.split()] for ln in lines["t"]])
    b = np.array([[float(x) for x in ln.split()] for ln in lines["j"]])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def _drop_protocol(mod, cfg, frames):
    """Hold the tracker's lock so the consumer blocks on its first frame,
    then offer the rest: two wait in the queue, the others are dropped."""
    kw = {"device": "cpu"} if mod is tsys else {}
    s = mod.System(cfg, mod.SENSOR_STEREO, use_pipeline=True,
                   enable_loop_closing=False, **kw)
    with s._lock:
        s.track_stereo(frames[0][0], frames[0][2])
        while not s._queue.empty():
            pass
        for img_pair, _, stamp in frames[1:]:
            assert s.track_stereo(img_pair, stamp) == {"queued": True}
    s.wait_idle(timeout=120.0)
    s.shutdown()
    return s._dropped, s.tracker.stats["n_frames"]


def test_pipeline_pose_callback(systems, sequence):
    """With `use_pipeline` the consumer thread hands each tracked frame's pose
    to `pose_callback` (tests/test_system_io.py::TestSystem::
    test_async_pipeline_with_backpressure). Offered one at a time, no frame
    drops: the callback fires once per frame, in order, with the poses of
    the synchronous run (the same arithmetic on the same thread-free path)
    and, to 1e-5, the reference's; `shutdown` joins the thread."""
    js, ts_, _, _ = systems
    frames = sequence[0][:8]
    got = []
    s = tsys.System(small_cfg(TCfg, sequence[1]), tsys.SENSOR_STEREO, use_pipeline=True,
                    enable_loop_closing=False, device="cpu",
                    pose_callback=lambda R, t, stamp, out: got.append((stamp, R, t, out)))
    consumer = s._consumer
    for img_pair, _, stamp in frames:
        assert s.track_stereo(img_pair, stamp) == {"queued": True}
        s.wait_idle(timeout=120.0)
    s.shutdown()
    assert not consumer.is_alive() and s._consumer is None
    assert s._dropped == 0
    assert [g[0] for g in got] == [f[2] for f in frames]
    assert all(g[3]["state"] == OK for g in got[1:])
    for (stamp, R, t, _), (ts_sync, R_s, t_s), (_, R_j, t_j) in zip(
            got, ts_.tracker.trajectory, js.tracker.trajectory):
        assert stamp == ts_sync
        np.testing.assert_array_equal(R, R_s)
        np.testing.assert_array_equal(t, t_s)
        np.testing.assert_allclose(R, R_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(t, t_j, rtol=0, atol=1e-5)


def test_pipeline_drops_on_backpressure(sequence, fast_reference_brief):
    frames, rig, _ = sequence
    frames = frames[:8]
    t = _drop_protocol(tsys, small_cfg(TCfg, rig), frames)
    j = _drop_protocol(jsys, small_cfg(JCfg, rig), frames)
    assert t == j == (len(frames) - 3, 3)


@pytest.mark.parametrize("sensor", [tsys.SENSOR_MONOCULAR, tsys.SENSOR_RGBD,
                                    tsys.SENSOR_IMU_MONOCULAR, tsys.SENSOR_IMU_STEREO])
def test_unported_sensors_raise(sensor):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsys.System(TCfg(), sensor, device="cpu")


def test_unported_options_raise(sequence):
    _, rig, _ = sequence
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsys.System(small_cfg(TCfg, rig), background_mapping=True, device="cpu")
    s = tsys.System(small_cfg(TCfg, rig), device="cpu")
    for call in (lambda: s.save_atlas("a.npz"), lambda: s.load_atlas("a.npz"),
                 lambda: s.track_monocular(np.zeros((8, 8)), 0.0),
                 lambda: s.track_stereo(np.zeros((2, 8, 8)), 0.0, imu=(0, 0, 0))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    cfg = small_cfg(TCfg, rig)
    cfg.mapping.async_gba = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsys.System(cfg, device="cpu")


def test_entry_points_default_to_the_card(sequence):
    """Without a card, the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, rig, _ = sequence
    with pytest.raises(RuntimeError, match="CUDA"):
        tsys.System(small_cfg(TCfg, rig))


def test_viz_bytes_agree(systems, tmp_path):
    """The same map arrays give the same PNG and PLY bytes in both packages;
    `render_map` goes through matplotlib in both (same image)."""
    js, ts_, _, _ = systems
    arrays = tms.to_numpy(ts_.tracker.map)
    jmap = js.tracker.map._replace(**{k: np.asarray(v) for k, v in arrays.items()})
    traj = ts_.tracker.trajectory
    rgb = np.random.default_rng(2).integers(0, 256, (60, 80, 3)).astype(np.uint8)
    out = {}
    for name, viz in (("j", jviz), ("t", tviz)):
        viz.write_png(str(tmp_path / f"{name}_frame.png"), rgb)
        viz.export_ply(str(tmp_path / f"{name}.ply"), jmap if name == "j" else ts_.tracker.map,
                       trajectory=traj)
        viz.render_map(str(tmp_path / f"{name}_map.png"),
                       jmap if name == "j" else ts_.tracker.map, trajectory=traj)
        out[name] = [open(tmp_path / f, "rb").read() for f in
                     (f"{name}_frame.png", f"{name}.ply", f"{name}_map.png")]
    assert out["t"] == out["j"]
    ts_.export_map_ply(str(tmp_path / "sys.ply"))
    assert open(tmp_path / "sys.ply", "rb").read() == out["t"][1]
    ts_.save_map_render(str(tmp_path / "sys.png"))
    assert os.path.getsize(tmp_path / "sys.png") > 1000


def _unported_cfg(case):
    cfg = TCfg()
    if case == "imu":
        cfg.use_imu = True
    elif case == "radtan_unrectified":
        cfg.camera.dist = (-0.28, 0.07, 0.0, 0.0, 0.0)
    elif case == "fisheye_pinhole":
        cfg.stereo.fisheye = True
    elif case == "fixed_ba_window":
        cfg.mapping.covis_ba_window = False
    elif case == "async_gba":
        cfg.mapping.async_gba = True
    return cfg


@pytest.mark.parametrize("case", ["mono", "imu", "radtan_unrectified", "fisheye_pinhole",
                                  "fixed_ba_window", "async_gba"])
def test_tracker_unported_configurations_raise(case):
    """Every configuration the port does not have raises, naming its ROADMAP
    item, before anything runs."""
    from orbslam3lib_tpu_torch.tracking.tracker import Tracker
    sensor = "mono" if case == "mono" else "stereo"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Tracker(_unported_cfg(case), sensor, device="cpu")
