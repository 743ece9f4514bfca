"""The pipelined tracker with lagged loops: the port's `Tracker(cfg,
"stereo", pipeline=6, chunk=2)` against the JAX reference's, mapping
inline, loop closing on, on the 125 frames of the room orbit with an 8 s
period of tests/test_torch_loop_slam.py (`torch_parity.loop_config`).

On this path the keyframe's mapper step only dispatches the loop probe;
its pack rides the next chunk's read, and the consumer runs the loop
closer on it before the frames read with it, composing the correction's
rigid delta onto their poses (reference tracker.py:1095-1135). Both
packages' RANSACs draw the reference's hypotheses, the reference's global
BA takes its single-device route, and its chunk reads run when submitted
(`torch_parity.InlineFetches`), so that both consume each chunk right
after it is dispatched.

Both trackers track the first WARM frames synchronously (`pipeline` 0)
and then pipelined: a pipelined chain starts without landmark bindings, so
its first frame has no motion-model stage and rests on the velocity, and
right after initialisation that velocity is the identity. On this orbit
(3 degrees a frame at 320x200) such a frame is lost, the synchronous frame
after the loss takes its velocity over the frames dropped with it, and the
next chain starts from that velocity and is lost again: both packages
lose every third frame from a cold start (`test_cold_start_cycle`, a
fault of the reference that the port carries, ROADMAP queue 3). Three
synchronous frames give the first chain a frame-to-frame velocity.

Checked: per call the same state, keyframe count, loop count and
trajectory length; the same loop at the same keyframe pair, (0, 40),
found from a probe consumed one chunk after its keyframe (frame 122); camera centres within 0.5 mm
and keyframe poses within 0.5 mm / 0.5 mrad after the correction and the
global BA (as tests/test_torch_loop_slam.py).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import (InlineFetches, fast_reference_brief,  # noqa: E402,F401
                          loop_config, orbit_frames, reference_ransac_draws,
                          reference_single_device_gba)
from torch_parity import reference_lie  # noqa: E402,F401

N_FRAMES = 125
PERIOD = 8.0
WARM = 3


@pytest.fixture(scope="module")
def frames():
    return orbit_frames(N_FRAMES, period=PERIOD)


def _trackers(rig):
    kw = dict(enable_loop_closing=True, pipeline=6, chunk=2)
    jt = jtr.Tracker(loop_config(JCfg, rig), "stereo", **kw)
    jt._fetch_pool = InlineFetches()
    return jt, ttr.Tracker(loop_config(TCfg, rig), "stereo", device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(frames, fast_reference_brief):
    imgs, ts, rig = frames
    jt, tt = _trackers(rig)
    rec = {"j": [], "t": []}
    with reference_ransac_draws(), reference_single_device_gba():
        for i, (img, stamp) in enumerate(zip(imgs, ts)):
            for key, tr in (("j", jt), ("t", tt)):
                tr.pipeline = 0 if i < WARM else 6
                res = tr.process_frame(img, float(stamp))
                rec[key].append((int(res["state"]), tr.stats["n_kf"], tr.stats["n_loops"],
                                 len(tr.trajectory)))
        for key, tr in (("j", jt), ("t", tt)):
            tr.finish()
            rec[key].append((int(tr.state), tr.stats["n_kf"], tr.stats["n_loops"],
                             len(tr.trajectory)))
    return rec, jt, tt


def test_same_lagged_loop(runs):
    """The loop the synchronous trackers close at frame 119
    (tests/test_torch_loop_slam.py), keyframe 40 against 0, closed here
    from the lagged probe, consumed at frame 122."""
    rec, jt, tt = runs
    assert rec["t"] == rec["j"]
    assert [i for i, r in enumerate(rec["t"]) if r[2] == 1][0] == 122
    assert tt.stats["n_loops"] == jt.stats["n_loops"] == 1
    assert tt.loop_closer.loop_edges == [tuple(e) for e in jt.loop_closer.loop_edges] \
        == [(0, 40)]
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 0
    assert len(tt.trajectory) == N_FRAMES


def test_poses_agree_after_the_loop(runs):
    _, jt, tt = runs
    np.testing.assert_allclose(tt.trajectory_centers(), jt.trajectory_centers(),
                               rtol=0, atol=5e-4)
    n = int(jt.map.n_kf)
    jv = np.asarray(jt.map.kf_valid)[:n]
    np.testing.assert_array_equal(tt.map.kf_valid.numpy()[:n], jv)
    Rj, tj = np.asarray(jt.map.kf_R)[:n][jv], np.asarray(jt.map.kf_t)[:n][jv]
    Rt, t_ = tt.map.kf_R.numpy()[:n][jv], tt.map.kf_t.numpy()[:n][jv]
    np.testing.assert_allclose(-np.einsum("kji,kj->ki", Rt, t_),
                               -np.einsum("kji,kj->ki", Rj, tj), rtol=0, atol=5e-4)
    D = np.einsum("kji,kjl->kil", Rt, Rj)
    ang = np.linalg.norm(np.stack([D[:, 2, 1] - D[:, 1, 2], D[:, 0, 2] - D[:, 2, 0],
                                   D[:, 1, 0] - D[:, 0, 1]], axis=1), axis=1) / 2.0
    assert ang.max() < 5e-4


def test_cold_start_cycle(frames, fast_reference_brief):
    """The reference's fault, in both packages: pipelined from the first
    frame on, the first frame of every chain is lost and the two after it
    are dropped, identically."""
    imgs, ts, rig = frames
    jt, tt = _trackers(rig)
    rec = {"j": [], "t": []}
    with reference_ransac_draws(), reference_single_device_gba():
        for img, stamp in zip(imgs[:15], ts[:15]):
            for key, tr in (("j", jt), ("t", tt)):
                res = tr.process_frame(img, float(stamp))
                rec[key].append((int(res["state"]), tr.stats["track_fail"],
                                 len(tr.trajectory)))
    assert rec["t"] == rec["j"]
    assert tt.stats["track_fail"] == jt.stats["track_fail"] >= 4
