"""The port's public API (`orbslam3lib_tpu_torch.system.System`) against the
JAX reference's `System`, as tests/test_system_io.py::TestSystem::
test_sync_stereo_pipeline drives it: the first 20 frames of its corridor
sequence through `track_stereo`, then the TUM and KITTI trajectory files,
whose numbers agree to 1e-5 line by line. Also: the pipeline's backpressure
(a queue of depth 2 that drops frames while the consumer is busy) drops
the same frames in both; the sensors and options not ported raise
NotImplementedError, and the ported background mapper and asynchronous
global BA run; the PNG writer, the map render and the PLY export
give the same bytes as the reference's `viz` for the same map arrays;
mono and RGB-D build and track through their entry points;
`save_atlas` writes the reference's file (each package loads the other's),
and what each package does after `load_atlas`."""
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
    assert ti["n_maps"] == ji["n_maps"] == 1
    for k in ("n_kf", "n_frames", "track_fail", "n_loops", "n_new_maps", "n_map_merges"):
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
def test_unported_sensors_raise(sensor, sequence):
    """The inertial sensors raise, naming their ROADMAP item; mono and
    RGB-D (which raised before they were ported) build and track frames
    through their entry points."""
    if sensor in (tsys.SENSOR_IMU_MONOCULAR, tsys.SENSOR_IMU_STEREO):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsys.System(TCfg(), sensor, device="cpu")
        return
    frames, rig, _ = sequence
    s = tsys.System(small_cfg(TCfg, rig), sensor, enable_loop_closing=False, device="cpu")
    for pair, _, stamp in frames[:6]:
        if sensor == tsys.SENSOR_MONOCULAR:
            s.track_monocular(pair[0], stamp)
        else:
            s.track_rgbd(pair[0], np.full(pair[0].shape, 4.0, np.float32), stamp)
    s.shutdown()
    assert s.get_stats()["n_frames"] == 6
    assert s.get_tracking_state() == OK


def test_unported_options_raise(sequence):
    """IMU input raises, naming its ROADMAP item; a monocular frame given
    to a stereo System is refused."""
    _, rig, _ = sequence
    s = tsys.System(small_cfg(TCfg, rig), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.track_stereo(np.zeros((2, 8, 8)), 0.0, imu=(0, 0, 0))
    with pytest.raises(ValueError, match="stereo"):
        s.track_monocular(np.zeros((8, 8)), 0.0)


def test_background_mapping_runs(systems, sequence):
    """`System(background_mapping=True)` (the reference's mapper thread,
    which raised before it was ported): the same frames give the
    synchronous System's trajectory within 5 mm (which keyframes a busy
    mapper lets through depends on timing); `shutdown` waits for the
    mapper's queue and joins its thread."""
    _, ts_, _, n = systems
    frames, rig, _ = sequence
    s = tsys.System(small_cfg(TCfg, rig), background_mapping=True, enable_loop_closing=False,
                    device="cpu")
    thread = s.tracker._mapper_thread
    assert thread is not None and thread.is_alive()
    for img_pair, _, stamp in frames:
        s.track_stereo(img_pair, stamp)
    s.shutdown()
    assert not thread.is_alive() and s.tracker._mapper_thread is None
    assert s.get_stats()["mapper_errors"] == 0 and s.get_tracking_state() == OK
    got, want = s.tracker.trajectory_centers(), ts_.tracker.trajectory_centers()
    assert len(got) == len(want) == n
    assert np.abs(got - want).max() < 0.005


def test_entry_points_default_to_the_card(sequence):
    """Without a card, the default device raises instead of falling back:
    `System`, with the mapper thread too, and the pipelined `Tracker`."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, rig, _ = sequence
    from orbslam3lib_tpu_torch.tracking.tracker import Tracker
    with pytest.raises(RuntimeError, match="CUDA"):
        tsys.System(small_cfg(TCfg, rig))
    with pytest.raises(RuntimeError, match="CUDA"):
        tsys.System(small_cfg(TCfg, rig), background_mapping=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Tracker(small_cfg(TCfg, rig), "stereo", pipeline=16, chunk=4, async_mapping=True)


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
    if case in ("imu", "mono_imu"):
        cfg.use_imu = True
    elif case in ("radtan_unrectified", "mono_radtan", "rgbd_radtan"):
        cfg.camera.dist = (-0.28, 0.07, 0.0, 0.0, 0.0)
    elif case == "mono_kb8":
        cfg.camera.model = "kannala_brandt8"
        cfg.camera.k = (0.02, -0.01, 0.003, 0.0)
    elif case == "fisheye_pinhole":
        cfg.stereo.fisheye = True
    elif case == "fixed_ba_window":
        cfg.mapping.covis_ba_window = False
    return cfg


@pytest.mark.parametrize("case", ["mono_imu", "imu", "radtan_unrectified", "fisheye_pinhole",
                                  "fixed_ba_window", "mono_radtan", "mono_kb8", "rgbd_radtan"])
def test_tracker_unported_configurations_raise(case):
    """Every configuration the port does not have raises, naming its ROADMAP
    item, before anything runs."""
    from orbslam3lib_tpu_torch.tracking.tracker import Tracker
    sensor = case.split("_")[0] if case.startswith(("mono", "rgbd")) else "stereo"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Tracker(_unported_cfg(case), sensor, device="cpu")


def test_async_gba_configuration_runs(sequence):
    """`cfg.mapping.async_gba` (which raised before the asynchronous global
    BA was ported) builds a System whose loop closer leaves the global BA to
    the tracker's GBA thread; frames track and `shutdown` returns with no
    thread left."""
    frames, rig, _ = sequence
    cfg = small_cfg(TCfg, rig)
    cfg.mapping.async_gba = True
    s = tsys.System(cfg, background_mapping=True, device="cpu")
    for img_pair, _, stamp in frames[:6]:
        s.track_stereo(img_pair, stamp)
    assert s.tracker.loop_closer is not None and s.tracker.loop_closer.async_gba
    s.shutdown()
    assert s.tracker._gba_thread is None and s.tracker._mapper_thread is None
    assert s.get_tracking_state() == OK and s.get_stats()["gba_errors"] == 0


def _atlas_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_atlas_files_load_across_packages(systems, tmp_path):
    """`save_atlas` writes the reference's file: the same keys, dtypes and
    values for the same run, and each package's file loads in the other
    with every array equal."""
    from orbslam3lib_tpu.models import serialization as jser
    from orbslam3lib_tpu_torch.models import serialization as tser
    js, ts_, _, _ = systems
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    js.save_atlas(jpath)
    ts_.save_atlas(tpath)
    ja, ta = _atlas_arrays(jpath), _atlas_arrays(tpath)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and ja[k].shape == ta[k].shape, k
    for k in ("_n_maps", "_current", "_dims", "map0_n_kf", "map0_kf_valid", "map0_mp_valid"):
        np.testing.assert_array_equal(ta[k], ja[k])
    # the JAX file in the port, the port's file in the JAX package
    t_from_j = tser.load_atlas(jpath, device="cpu")
    j_from_t = jser.load_atlas(tpath)
    assert (t_from_j.count_maps(), t_from_j.current) == (1, 0)
    assert (j_from_t.count_maps(), j_from_t.current) == (1, 0)
    for k in tms.FIELDS:
        np.testing.assert_array_equal(getattr(t_from_j.maps[0], k).numpy(), ja[f"map0_{k}"])
        np.testing.assert_array_equal(np.asarray(getattr(j_from_t.maps[0], k)), ta[f"map0_{k}"])


def test_save_load_round_trip(systems, sequence, tmp_path):
    """The port's file loads into a fresh System with every array equal and
    the same `map_info`."""
    _, ts_, _, _ = systems
    frames, rig, _ = sequence
    path = str(tmp_path / "t.npz")
    ts_.save_atlas(path)
    fresh = tsys.System(small_cfg(TCfg, rig), enable_loop_closing=False, device="cpu")
    fresh.load_atlas(path)
    assert fresh.map_info() == ts_.map_info()
    for a, b in zip(fresh.tracker.atlas.maps, ts_.tracker.atlas.maps):
        for k in tms.FIELDS:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    fresh.shutdown()


def test_save_atlas_while_the_mapper_thread_runs(sequence, tmp_path):
    """With `background_mapping` the mapper thread inserts keyframes and
    merges maps under the tracker's map lock, so `save_atlas` and
    `map_info` wait for it: held by another thread, neither returns until
    it is released. A save after every frame, the mapper thread still at
    work, loads back with the keyframe count never falling; after
    `shutdown` the file equals the Atlas array for array."""
    import threading

    from orbslam3lib_tpu_torch.models import serialization as tser
    frames, rig, _ = sequence
    s = tsys.System(small_cfg(TCfg, rig), background_mapping=True, enable_loop_closing=False,
                    device="cpu")
    for call in (lambda: s.save_atlas(str(tmp_path / "held.npz")), s.map_info):
        with s.tracker._map_lock:
            th = threading.Thread(target=call)
            th.start()
            th.join(0.3)
            assert th.is_alive()              # waits for the map lock
        th.join(10.0)
        assert not th.is_alive()
    n_kf = []
    for i, (img_pair, _, stamp) in enumerate(frames):
        s.track_stereo(img_pair, stamp)
        path = str(tmp_path / f"{i}.npz")
        s.save_atlas(path)
        at = tser.load_atlas(path, device="cpu")
        assert at.count_maps() == 1 and at.current == 0
        n_kf.append(int(at.current_map.n_kf))
    s.shutdown()
    assert n_kf == sorted(n_kf) and n_kf[-1] > 1
    assert s.get_stats()["mapper_errors"] == 0
    path = str(tmp_path / "final.npz")
    s.save_atlas(path)
    loaded = tser.load_atlas(path, device="cpu")
    for k in tms.FIELDS:
        assert torch.equal(getattr(loaded.maps[0], k), getattr(s.tracker.map, k)), k


def test_load_atlas_starts_a_map_of_its_own(systems, sequence, tmp_path):
    """What each package does after `load_atlas` and one more frame.

    Named exception, a fault of the reference (ROADMAP queue 3): its
    `System.load_atlas` swaps the Atlas and nothing else, so its live BoW
    database stays empty of the loaded keyframes and its next
    initialisation inserts a keyframe at the identity pose into the loaded
    map. The port starts over on the loaded maps: the live database is
    rebuilt from the loaded map, and the first initialisation archives it
    (its database goes to the map merger) and starts a map of its own."""
    js, _, _, _ = systems
    frames, rig, _ = sequence
    path = str(tmp_path / "j.npz")
    js.save_atlas(path)
    n_kf = js.map_info()["n_kf"]
    img, _, stamp = frames[0]

    jfresh = jsys.System(small_cfg(JCfg, rig), jsys.SENSOR_STEREO)
    jfresh.load_atlas(path)
    jfresh.track_stereo(img, stamp)
    assert jfresh.map_info()["n_maps"] == 1
    assert jfresh.map_info()["n_kf"] == n_kf + 1               # into the loaded map
    assert int(np.asarray(jfresh.tracker.place_rec.active).sum()) == 1
    jfresh.shutdown()

    tfresh = tsys.System(small_cfg(TCfg, rig), device="cpu")
    tfresh.load_atlas(path)
    tr = tfresh.tracker
    assert int(tr.place_rec.active.sum()) == n_kf              # rebuilt from the map
    loaded = tr.atlas.current_map
    tfresh.track_stereo(img, stamp)
    assert tfresh.map_info()["n_maps"] == 2 and tfresh.map_info()["n_kf"] == 1
    assert tr.atlas.maps[0] is loaded and int(loaded.n_kf) == n_kf
    arc = tr.map_merger.archives
    assert [a["map_idx"] for a in arc] == [0] and int(arc[0]["db"].active.sum()) == n_kf
    assert tfresh.get_stats()["n_new_maps"] == 1
    tfresh.shutdown()
