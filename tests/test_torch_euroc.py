"""The port's ASL-folder loader (`orbslam3lib_tpu_torch/io/euroc.py`)
against the reference's (`orbslam3lib_tpu/io/euroc.py`, which reads PNGs
through PIL): its own PNG decoder on every scanline filter and on PIL's
files; a sequence written by the reference's `write_minimal_sequence`
(tests/test_system_io.py::TestEurocLoader's layout: stereo, a 100 Hz IMU,
ground truth) read by both loaders, frames, IMU chunks and ground truth
equal; and `System("imu_stereo")` run from a folder the port wrote (26
corridor frames and a 200 Hz IMU): the IMU initialises and tracking holds.
"""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from orbslam3lib_tpu.io import euroc as jeu
from orbslam3lib_tpu_torch.config import SlamConfig
from orbslam3lib_tpu_torch.io import euroc as teu
from orbslam3lib_tpu_torch.io.synthetic import render_stereo_sequence, synth_imu


def _filtered_png(path, img, ftype):
    """Write `img` (H, W) or (H, W, C) uint8 with every row under scanline
    filter `ftype` (the PNG spec's forward filters)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int32)
    out, prev = [], np.zeros(w * ch, np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - left
        elif ftype == 2:
            f = cur - prev
        elif ftype == 3:
            f = cur - ((left + prev) >> 1)
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = cur - pred
        out.append(bytes([ftype]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + \
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ctype = {1: 0, 3: 2, 4: 6}[ch]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                                 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
def test_png_decoder(tmp_path, ftype, channels):
    """Every filter, grayscale and RGB: the decoder gives the image back,
    as PIL reads the same file; `load_image` of RGB equals PIL's "L"."""
    rng = np.random.default_rng(ftype * 7 + channels)
    shape = (23, 37) if channels == 1 else (23, 37, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    _filtered_png(path, img, ftype)
    assert np.array_equal(teu.read_png(path), img)
    assert np.array_equal(np.asarray(Image.open(path)), img)
    want = np.asarray(Image.open(path).convert("L"), np.float32)
    assert np.array_equal(teu.load_image(path), want)


def test_png_writer_reads_in_pil(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (40, 64)).astype(np.uint8)
    path = str(tmp_path / "g.png")
    teu.write_png(path, img)
    assert np.array_equal(np.asarray(Image.open(path)), img)


@pytest.fixture(scope="module")
def frames():
    return render_stereo_sequence(26, seed=5)


def test_roundtrip_matches_reference(tmp_path, frames):
    """A folder written by the reference's writer (PIL), read by both
    loaders: the same images, stamps, IMU chunks and ground truth."""
    seq_frames, rig, _ = frames
    fr = seq_frames[:6]
    tss = [f[2] for f in fr]
    gyro, acc, dts = synth_imu(tss[0], tss[-1], freq=100.0)
    imu = np.concatenate([(np.cumsum(dts) + tss[0])[:, None], gyro, acc], axis=1)
    gt = np.asarray([[ts, *(-f[1][0].T @ f[1][1]), 1, 0, 0, 0] for f, ts in zip(fr, tss)])
    root = str(tmp_path / "seq")
    jeu.write_minimal_sequence(root, [f[0][0] for f in fr], tss, [f[0][1] for f in fr], imu, gt)
    js, ts_ = jeu.EurocSequence(root), teu.EurocSequence(root)
    assert len(ts_) == len(js) == 6
    n_imu = 0
    for (ji, jt, jc), (ti, tt, tc) in zip(js.frames(), ts_.frames()):
        assert ti.shape == (2, rig.height, rig.width) and np.array_equal(ti, ji)
        assert tt == jt
        assert (jc is None) == (tc is None)
        if tc is not None:
            n_imu += len(tc[2])
            for a, b in zip(tc, jc):
                assert np.array_equal(a, b)
    assert n_imu > 0
    np.testing.assert_array_equal(ts_.gt_centers_at(np.asarray(tss)),
                                  js.gt_centers_at(np.asarray(tss)))
    mono = list(teu.EurocSequence(root, stereo=False).frames(end=2))
    assert mono[0][0].shape == (rig.height, rig.width)


def test_imu_stereo_system_from_a_directory(tmp_path, frames):
    """26 corridor frames and the corridor's 200 Hz IMU written as an ASL
    folder by the port, then `System(cfg, "imu_stereo")` fed from
    `EurocSequence.frames()`: every frame tracks, the IMU initialises, and
    the trajectory's ATE against the folder's ground truth is under 2 cm."""
    from orbslam3lib_tpu_torch.evaluation import ate_rmse
    from orbslam3lib_tpu_torch.system import System
    seq_frames, rig, _ = frames
    tss = [f[2] for f in seq_frames]
    ci = SlamConfig().imu
    rng = np.random.default_rng(0)
    gyro, acc, dts = synth_imu(tss[0], tss[-1], freq=ci.freq,
                               sigma_g=ci.noise_gyro * np.sqrt(ci.freq),
                               sigma_a=ci.noise_acc * np.sqrt(ci.freq), rng=rng)
    imu = np.concatenate([(tss[0] + np.arange(1, len(dts) + 1) / ci.freq)[:, None], gyro, acc],
                         axis=1)
    gt = np.asarray([[f[2], *(-f[1][0].T @ f[1][1]), 1, 0, 0, 0] for f in seq_frames])
    root = str(tmp_path / "vi")
    teu.write_minimal_sequence(root, [f[0][0] for f in seq_frames], tss,
                               [f[0][1] for f in seq_frames], imu, gt)
    seq = teu.EurocSequence(root)
    cfg = SlamConfig()
    cfg.map.max_kf, cfg.map.max_mp = 64, 4096
    cfg.orb.max_kp, cfg.orb.target_features, cfg.orb.fast_threshold = 384, 300, 12.0
    cfg.tracker.min_init_features = 150
    cfg.ba.max_points, cfg.ba.window_size = 1024, 6
    cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy = rig.fx, rig.fy, rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    s = System(cfg, "imu_stereo", enable_loop_closing=False, device="cpu")
    states = [s.track_stereo(imgs, ts, imu=chunk)["state"] for imgs, ts, chunk in seq.frames()]
    s.shutdown()
    assert all(x == 1 for x in states) and s.tracker.imu_ready
    est = s.tracker.trajectory_centers()
    stamps = np.array([f[0] for f in s.tracker.trajectory])
    assert ate_rmse(est, seq.gt_centers_at(stamps)) < 0.02
