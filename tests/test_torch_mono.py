"""Monocular SLAM, the port against the JAX reference: both
`Tracker(cfg, "mono")` frame by frame on tests/test_slam_modes.py's
40-frame corridor (640x400, 384 keypoints; the reference initialises there
and holds, unlike on the 8 s orbit at 320x200, whose 3 degrees a frame is
too fast for one camera), with the back end on and loop closing off.

Both run on the reference's RANSAC draws (`torch_parity.reference_ransac_draws`:
the two-view hypotheses too) and with the reference's median-depth fault
put back in the port (`reference_median_fault`): the reference's
`_mono_init_map` (tracker.py:406-408) takes `jnp.median` over the
triangulated depths with NaN in every other slot, which is NaN, turned
into 1, so its initial map keeps the two-view reconstruction's unit
baseline; the port scales it to median depth 1, as ORB-SLAM3's
CreateInitialMapMonocular does. `test_reference_median_depth_fault` shows
the fault on the reference and the port's own normalisation.

Held: the same initialisation frame, states, keyframe decisions and
landmark counts, and the camera centres within 2e-3 of the scene's scale
(the map's median depth: the two-view map is 10-40 baselines deep and every
f32 difference of the initial SVDs and BA steps is carried in those
units). Also: a reset in the middle of an initialisation attempt restarts
it in both, and `Tracker(pipeline=6)` runs monocular frames synchronously.
"""
import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import render_stereo_sequence  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import fast_reference_brief, reference_ransac_draws  # noqa: E402,F401
from torch_parity import reference_lie  # noqa: E402,F401

N_FRAMES = 40


def corridor_config(cfg_cls, rig):
    """tests/test_slam_modes.py's configuration."""
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


@contextlib.contextmanager
def reference_median_fault():
    """The port's initial monocular map keeps the two-view scale, as the
    reference's does (`scene_median_depth` reads 1, the reference's
    `jnp.nan_to_num(jnp.median(...), nan=1.0)` on its NaN median)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "scene_median_depth",
                   lambda p3d, tri_ok: torch.ones((), device=p3d.device))
        yield


@contextlib.contextmanager
def captured_inits(store):
    """Keep each package's `_mono_init_map` arguments and result map."""
    real_j, real_t = jtr._mono_init_map, ttr._mono_init_map

    def j_init(*a, **k):
        out = real_j(*a, **k)
        store.setdefault("j", []).append((a, out))
        return out

    def t_init(*a, **k):
        out = real_t(*a, **k)
        store.setdefault("t", []).append((a, tms.to_numpy(out[0])))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "_mono_init_map", j_init)
        mp.setattr(ttr, "_mono_init_map", t_init)
        yield


@pytest.fixture(scope="module")
def sequence():
    frames, rig, _ = render_stereo_sequence(n_frames=N_FRAMES, dt=1.0 / 15.0, seed=5)
    return frames, rig


def _record(tr, res, key):
    rec = dict(res)
    if tr.pose is not None:
        R, t = (np.asarray(x if key == "j" else x.numpy(), np.float64) for x in tr.pose)
        rec["c"] = -R.T @ t
    rec["n_mp"] = int(tr.map.n_mp)
    return rec


def _run_both(frames, rig, reset_after=None):
    """Both trackers over the frames; with `reset_after`, both reset their
    active map after that frame. Returns per-frame records, the trackers
    and the captured initialisations."""
    out, inits = {"j": [], "t": []}, {}
    with reference_ransac_draws(), reference_median_fault(), captured_inits(inits):
        jt = jtr.Tracker(corridor_config(JCfg, rig), "mono", enable_loop_closing=False,
                         pipeline=0)
        tt = ttr.Tracker(corridor_config(TCfg, rig), "mono", device="cpu",
                         enable_loop_closing=False)
        for i, (pair, _, stamp) in enumerate(frames):
            for key, tr in (("j", jt), ("t", tt)):
                out[key].append(_record(tr, tr.process_frame(pair[0], stamp), key))
                if i == reset_after:
                    tr._reset_active_map()
    return out, jt, tt, inits


@pytest.fixture(scope="module")
def runs(sequence, fast_reference_brief):
    frames, rig = sequence
    return _run_both(frames, rig)


def _scene_scale(tracker_map) -> float:
    m = tms.to_numpy(tracker_map)
    return float(np.median(np.abs(m["mp_pos"][m["mp_valid"]][:, 2])))


def test_trackers_agree_frame_by_frame(runs):
    out, jt, tt, inits = runs
    states = [r["state"] for r in out["j"]]
    assert [r["state"] for r in out["t"]] == states
    init_frame = states.index(jtr.OK)
    assert out["t"][init_frame].get("init") and out["j"][init_frame].get("init")
    assert len(inits["j"]) == len(inits["t"]) == 1
    assert all(s == jtr.OK for s in states[init_frame:])
    assert [r.get("kf") for r in out["t"]] == [r.get("kf") for r in out["j"]]
    assert [r["n_mp"] for r in out["t"]] == [r["n_mp"] for r in out["j"]]
    assert tt.stats["n_kf"] == jt.stats["n_kf"] >= 3
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 0
    scale = _scene_scale(tt.map)
    err = max(np.linalg.norm(a["c"] - b["c"]) for a, b in zip(out["t"], out["j"]) if "c" in a)
    assert err < 2e-3 * scale, (err, scale)


def test_reference_median_depth_fault(runs):
    """The reference's initial map is not scaled: its landmarks' median
    depth in the first keyframe is the two-view reconstruction's own (many
    baselines), while the port's `_mono_init_map` on the same
    reconstruction scales it to 1 (the lower median of the triangulated
    depths: exactly 1 up to f32 rounding)."""
    _, _, _, inits = runs
    a, (jm, *_) = inits["j"][0]     # (map, ts0, ts1, f0 (5), f1 (5), idx, tri_ok, R, t, p3d, ...)
    tri_ok, p3d = np.asarray(a[14]), np.asarray(a[17])
    z = p3d[tri_ok, 2]
    raw = float(np.sort(z)[(len(z) - 1) // 2])
    m = {k: np.asarray(v) for k, v in jm._asdict().items()}
    z_map = m["mp_pos"][m["mp_valid"]][:, 2]
    assert raw > 3.0
    np.testing.assert_allclose(np.sort(z_map)[(len(z_map) - 1) // 2], raw, rtol=1e-6)
    # the port, unpatched, on the same reconstruction
    def tt(x):
        return torch.from_numpy(np.array(x))
    tm, kf1, _, t21 = ttr._mono_init_map(
        tms.empty_map(64, 4096, 384), float(a[1]), float(a[2]),
        tuple(tt(x) for x in a[3:8]), tuple(tt(x) for x in a[8:13]), tt(a[13]),
        tt(tri_ok), tt(a[15]), tt(a[16]), tt(p3d), n_levels=8)
    mt = tms.to_numpy(tm)
    zt = mt["mp_pos"][mt["mp_valid"]][:, 2]
    assert kf1 == 1 and len(zt) == len(z_map)
    np.testing.assert_allclose(np.sort(zt)[(len(zt) - 1) // 2], 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(t21.numpy()), 1.0 / raw, rtol=1e-5)


def test_reset_mid_initialisation(sequence, fast_reference_brief):
    """A reset after the attempt's first frame drops the attempt in both
    (`_init_frame`); the next attempt starts on the following frame and
    both initialise on the same frame."""
    frames, rig = sequence
    out, jt, tt, _ = _run_both(frames[:10], rig, reset_after=0)
    states = [r["state"] for r in out["j"]]
    assert [r["state"] for r in out["t"]] == states
    assert jt.stats["n_resets"] == tt.stats["n_resets"] == 1
    first = states.index(jtr.OK)
    assert first >= 2 and all(s == jtr.OK for s in states[first:])


def test_pipelined_mono_runs_synchronously(sequence):
    """`pipeline` is the stereo hot path's (reference :805-810): a monocular
    Tracker(pipeline=6) gives the synchronous tracker's results exactly."""
    frames, rig = sequence
    with reference_median_fault():
        runs = []
        for pipeline in (0, 6):
            tr = ttr.Tracker(corridor_config(TCfg, rig), "mono", device="cpu",
                             enable_loop_closing=False, pipeline=pipeline, chunk=2)
            res = [tr.process_frame(pair[0], stamp) for pair, _, stamp in frames[:12]]
            runs.append((res, tr.trajectory_centers()))
    (r0, c0), (r6, c6) = runs
    assert r6 == r0 and not any("pipelined" in r for r in r6)
    assert any(r.get("init") for r in r6)
    np.testing.assert_array_equal(c6, c0)


def test_mono_frame_shapes(sequence):
    """A monocular frame is (H, W) or (1, H, W); a pair or a depth map is
    refused with the sensor named."""
    frames, rig = sequence
    tr = ttr.Tracker(corridor_config(TCfg, rig), "mono", device="cpu",
                     enable_loop_closing=False)
    img = frames[0][0][0]
    tr.process_frame(img[None], frames[0][2])
    with pytest.raises(ValueError, match="mono"):
        tr.process_frame(frames[1][0], frames[1][2])
    with pytest.raises(ValueError, match="mono"):
        tr.process_frame(img, frames[1][2], depth_map=np.ones_like(img))
