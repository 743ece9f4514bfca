"""The slice as a whole with a loop: synchronous stereo SLAM with loop
closing, the port's `Tracker(cfg, "stereo", device="cpu")` against the JAX
reference's `Tracker(cfg, "stereo", enable_loop_closing=True, pipeline=0)`
on the same 125 frames of bench.py's room orbit at 320x200 with a period of
8 s (120 frames a revolution; `torch_parity.loop_config`: 4 levels, 256
keypoints, 64 KF / 4096 MP, BA window 3 + 2 with 1024 points). The
reference closes its first loop at frame 119, keyframe 40 against keyframe
0, and runs its global BA.

Both packages' RANSACs draw the reference's hypotheses
(`torch_parity.reference_ransac_draws`), and the reference's global BA
takes its single-device route, as on one chip. Checked: per frame the same state,
keyframe decision and loop count; the same loop pair and verification
counts; camera centres within 0.5 mm and keyframe poses within 0.5 mm /
0.5 mrad (f32 solves summed in another order over 125 frames, a pose graph
and a global BA; observed 2e-5 m before the loop).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.evaluation import ate_rmse  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import (fast_reference_brief, loop_config,  # noqa: E402,F401
                          orbit_frames, reference_ransac_draws,
                          reference_single_device_gba)

N_FRAMES = 125
PERIOD = 8.0


@pytest.fixture(scope="module")
def runs(fast_reference_brief):
    imgs, ts, rig = orbit_frames(N_FRAMES, period=PERIOD)
    jt = jtr.Tracker(loop_config(JCfg, rig), "stereo", enable_loop_closing=True,
                     pipeline=0)
    tt = ttr.Tracker(loop_config(TCfg, rig), "stereo", device="cpu")
    rec = {"j": [], "t": []}
    with reference_ransac_draws(), reference_single_device_gba():
        for img, stamp in zip(imgs, ts):
            for key, tr in (("j", jt), ("t", tt)):
                res = tr.process_frame(img, float(stamp))
                rec[key].append((res["state"], bool(res.get("kf", False)),
                                 tr.stats["n_loops"]))
    return rec, jt, tt, ts


def test_same_states_keyframes_and_loop(runs):
    rec, jt, tt, _ = runs
    assert rec["t"] == rec["j"]
    loop_frames = [i for i, r in enumerate(rec["j"]) if r[2] == 1]
    assert loop_frames and loop_frames[0] == 119
    assert tt.stats["n_loops"] == jt.stats["n_loops"] == 1
    assert tt.loop_closer.loop_edges == [tuple(e) for e in jt.loop_closer.loop_edges] \
        == [(0, 40)]
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 0
    assert tt.stats["n_kf"] == jt.stats["n_kf"]
    # the verification that closed it: counts as in the reference's pack
    kf, cand, pack = tt.loop_closer.last_verification
    assert (kf, cand) == (40, 0)
    assert pack[:5].tolist() == [105.0, 66.0, 80.0, 66.0, 78.0]
    assert pack[17] == 1.0                                   # stereo: fixed scale


def test_poses_agree_after_the_loop(runs):
    _, jt, tt, ts = runs
    np.testing.assert_allclose(tt.trajectory_centers(), jt.trajectory_centers(),
                               rtol=0, atol=5e-4)
    n = int(jt.map.n_kf)
    jv = np.asarray(jt.map.kf_valid)[:n]
    np.testing.assert_array_equal(tt.map.kf_valid.numpy()[:n], jv)
    Rj, tj = np.asarray(jt.map.kf_R)[:n][jv], np.asarray(jt.map.kf_t)[:n][jv]
    Rt, t_ = tt.map.kf_R.numpy()[:n][jv], tt.map.kf_t.numpy()[:n][jv]
    cj = -np.einsum("kji,kj->ki", Rj, tj)
    ct = -np.einsum("kji,kj->ki", Rt, t_)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=5e-4)
    ang = np.arccos(np.clip((np.einsum("kij,kij->k", Rj, Rt) - 1.0) / 2.0, -1, 1))
    assert ang.max() < 5e-4


def test_ate_of_both_packages(runs):
    """Trajectory ATE and loop-corrected keyframe ATE against the analytic
    orbit: the port's within 0.5 mm of the reference's."""
    _, jt, tt, ts = runs
    _, gt = orbit_pose_at(ts, period=PERIOD, radius=0.5)
    ate_j = ate_rmse(jt.trajectory_centers(), gt)
    ate_t = ate_rmse(tt.trajectory_centers(), gt)
    assert abs(ate_t - ate_j) < 5e-4 and ate_t < 0.3

    def kf_ate(tr, origin):
        m = tr.map
        n = int(m.n_kf)
        v = np.asarray(m.kf_valid)[:n]
        R, t = np.asarray(m.kf_R)[:n][v], np.asarray(m.kf_t)[:n][v]
        kf_ts = np.asarray(m.kf_ts)[:n][v].astype(np.float64) + origin
        return ate_rmse(-np.einsum("kji,kj->ki", R, t),
                        orbit_pose_at(kf_ts, period=PERIOD, radius=0.5)[1])
    assert abs(kf_ate(tt, ts[0]) - kf_ate(jt, ts[0])) < 5e-4
