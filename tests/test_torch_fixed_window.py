"""The fixed local-BA window (`cfg.mapping.covis_ba_window = False`): the
port's `StereoTracker(cfg, device="cpu")` against the JAX reference's
`StereoTracker(cfg, pipeline=0)` (both the `Tracker(cfg, "stereo")` alias
with loop closing off) on the same 24 frames of bench.py's room orbit at
the slice's reduced size (`torch_parity.backend_config`: 320x200, 4
levels, 256 keypoints, a keyframe every 2 frames, BA window 3 + 2 with 1024
points). From the sixth keyframe on the window is the last 3 keyframe
slots with 2 anchors before them; before that keyframe 0 anchors it and is
in the window as well.

Checked, frame by frame: the same state and keyframe decision; every local
BA's window ids and fixed mask equal; camera centres within 5 mm and
rotations within 1 mrad (`test_torch_slam.py`'s bounds: f32 BA and pose
solves summed in another order); `trajectory_poses` against the
reference's within those bounds. The port's Lie maps take the reference's
small-angle arithmetic (`torch_parity.reference_lie`).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import (backend_config, fast_reference_brief,  # noqa: E402,F401
                          orbit_frames, reference_lie, rotation_angle)

N_FRAMES = 24


def _cfg(cls, rig):
    cfg = backend_config(cls, rig)
    cfg.mapping.covis_ba_window = False
    return cfg


def _recording(windows, real):
    def run(m, ids, fixed, *a, **k):
        windows.append((np.asarray(ids.cpu() if torch.is_tensor(ids) else ids).tolist(),
                        np.asarray(fixed.cpu() if torch.is_tensor(fixed) else fixed).tolist()))
        return real(m, ids, fixed, *a, **k)
    return run


@pytest.fixture(scope="module")
def runs(fast_reference_brief):
    imgs, ts, rig = orbit_frames(N_FRAMES)
    jt = jtr.StereoTracker(_cfg(JCfg, rig), pipeline=0)
    tt = ttr.StereoTracker(_cfg(TCfg, rig), device="cpu")
    rec = {"j": [], "t": []}
    win = {"j": [], "t": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "_local_ba", _recording(win["j"], jtr._local_ba))
        mp.setattr(ttr, "_local_ba", _recording(win["t"], ttr._local_ba))
        for img, stamp in zip(imgs, ts):
            for key, tr in (("j", jt), ("t", tt)):
                res = tr.process_frame(img, float(stamp))
                R, t = (np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float64)
                        for x in tr.pose)
                rec[key].append((res["state"], bool(res.get("kf", False)), R, t))
    return rec, win, jt, tt


def test_stereo_tracker_alias(runs):
    _, _, jt, tt = runs
    assert isinstance(tt, ttr.Tracker) and tt.sensor == "stereo"
    assert tt.enable_loop_closing is jt.enable_loop_closing is False
    assert tt.loop_closer is None and jt.loop_closer is None
    assert ttr.StereoTracker(TCfg(), device="cpu", enable_loop_closing=True).enable_loop_closing


def test_same_windows(runs):
    _, win, jt, tt = runs
    assert tt.stats["n_kf"] == jt.stats["n_kf"] >= 9
    assert len(win["t"]) == len(win["j"]) == tt.stats["n_kf"] - 2
    assert win["t"] == win["j"]
    ids, fixed = win["t"][-1]
    n = tt.stats["n_kf"]
    assert ids == [n - 5, n - 4, n - 3, n - 2, n - 1] and fixed == [True, True, False, False, False]
    assert win["t"][0] == ([0, 0, 1, 2, -1], [True, False, False, False, False])


def test_per_frame_states_and_poses(runs):
    rec, _, _, _ = runs
    for i, (fj, ft) in enumerate(zip(rec["j"], rec["t"])):
        assert ft[:2] == fj[:2] and ft[0] == ttr.OK, i
        (Rj, tj), (Rt, t_) = fj[2:], ft[2:]
        assert np.linalg.norm(Rj.T @ tj - Rt.T @ t_) < 5e-3, i
        assert rotation_angle(Rj, Rt) < 1e-3, i


def test_trajectory_poses(runs):
    _, _, jt, tt = runs
    got, want = tt.trajectory_poses(), jt.trajectory_poses()
    assert len(got) == len(want) == N_FRAMES
    for (ts_t, (Rt, t_)), (ts_j, (Rj, tj)) in zip(got, want):
        assert ts_t == pytest.approx(ts_j, abs=1e-9)
        assert rotation_angle(Rj, Rt) < 1e-3
        assert np.linalg.norm(np.asarray(Rj).T @ np.asarray(tj) - Rt.T @ t_) < 5e-3
    np.testing.assert_allclose(np.stack([-R.T @ t for _, (R, t) in got]),
                               tt.trajectory_centers(), rtol=0, atol=0)


def test_fixed_ba_window():
    """The window's arithmetic at every count of keyframes: the last 3 slots,
    up to 2 anchors before them, keyframe 0 when none precede them."""
    assert [ttr.fixed_ba_window(n, 3, 2)[0].tolist() for n in (3, 4, 5, 6, 9)] == [
        [0, 0, 1, 2, -1], [0, 1, 2, 3, -1], [0, 1, 2, 3, 4], [1, 2, 3, 4, 5],
        [4, 5, 6, 7, 8]]
    assert [ttr.fixed_ba_window(n, 3, 2)[1].sum() for n in (3, 4, 5, 6, 9)] == [1, 1, 2, 2, 2]
