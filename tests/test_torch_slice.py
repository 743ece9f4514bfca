"""The tracking core of the slice: synchronous stereo tracking with keyframe
insertion (`Tracker.process_frame`), the port against the JAX reference on
the same frames of bench.py's room orbit at a reduced rig size.

Both run `Tracker(cfg, "stereo", ...)` (the reference with
`enable_loop_closing=False, pipeline=0`) with the per-keyframe back end
(`_mapping_pipeline`) patched to a no-op in both packages, so that these
tests hold the tracking core alone; `test_torch_slam.py` holds the slice
with its back end.

Two disturbed runs reach the branches an undisturbed orbit never takes.
Before frame JOLT, either the motion prior is replaced by a wrong one
(0.2 rad about y, 0.3 m sideways): the projection search misses
`min_inliers` and the TrackReferenceKeyFrame fallback recovers the frame;
or the frame is a flat grey image: both attempts miss, the frame counts a
track failure and enters RECENTLY_LOST, and the next frame tracks again.
The reference queries its BoW database for relocalisation candidates on
that frame (it does whenever it has one, loop closing or not); a frame
without features finds none, so its loss handling is the port's, which
has no relocalisation yet."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.tracking import reloc as jreloc, tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import (fast_reference_brief, orbit_frames,  # noqa: E402,F401
                          mapping_off, slice_config)
from torch_parity import reference_lie  # noqa: E402,F401

N_FRAMES = 8


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


JOLT = 5


def _run_both(imgs, ts, rig, bad_prior=None):
    """Drive both trackers over the frames; with `bad_prior` (R, t), both
    start frame JOLT from that motion prior. Returns per-frame records, the
    two trackers, and how often the reference called track_reference_kf."""
    out = {"j": [], "t": []}
    n_ref_calls = [0]
    real = jreloc.track_reference_kf

    def counted(*a, **k):
        n_ref_calls[0] += 1
        return real(*a, **k)

    with mapping_off(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreloc, "track_reference_kf", counted)
        jt = jtr.Tracker(slice_config(JCfg, rig), "stereo",
                         enable_loop_closing=False, pipeline=0)
        tt = ttr.Tracker(slice_config(TCfg, rig), "stereo", device="cpu",
                         enable_loop_closing=False)
        for i, (img, stamp) in enumerate(zip(imgs, ts)):
            if i == JOLT and bad_prior is not None:
                jt.vel = tuple(jnp.asarray(x) for x in bad_prior)
                tt.vel = tuple(torch.from_numpy(x) for x in bad_prior)
            for key, tr in (("j", jt), ("t", tt)):
                res = tr.process_frame(img, float(stamp))
                R, t = (np.asarray(x, np.float64) for x in
                        ((tr.pose[0], tr.pose[1]) if key == "j"
                         else (tr.pose[0].numpy(), tr.pose[1].numpy())))
                out[key].append(dict(res, R=R, t=t, n_mp=int(tr.map.n_mp)))
    return out, jt, tt, n_ref_calls[0]


@pytest.fixture(scope="module")
def runs(fast_reference_brief):
    imgs, ts, rig = orbit_frames(N_FRAMES)
    out, jt, tt, _ = _run_both(imgs, ts, rig)
    return out, jt, tt


@pytest.fixture(scope="module", params=["bad_motion_prior", "blank_frame"])
def disturbed_runs(request, fast_reference_brief):
    imgs, ts, rig = orbit_frames(N_FRAMES)
    bad_prior = None
    if request.param == "blank_frame":
        imgs = imgs.copy()
        imgs[JOLT] = 90
    else:
        c, s = np.cos(0.2), np.sin(0.2)
        bad_prior = (np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32),
                     np.array([0.3, 0.0, 0.0], np.float32))
    return (request.param,) + _run_both(imgs, ts, rig, bad_prior)


def test_same_states_and_keyframe_decisions(runs):
    out, jt, tt = runs
    for fj, ft in zip(out["j"], out["t"]):
        assert ft["state"] == fj["state"] == ttr.OK
        assert ft.get("kf", False) == fj.get("kf", False)
        assert ft.get("init", False) == fj.get("init", False)
    assert tt.stats["n_kf"] == jt.stats["n_kf"] >= 2
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 0


def test_poses_and_map_agree(runs):
    """Per-frame camera centre within 5 mm and rotation within 1 mrad (the
    f32 pose solves and the 1e-5 pyramid rounding differ; observed < 1e-6
    m); the landmark count within 2% (a keypoint on an upper level may
    differ, and with it a spawned landmark; observed equal)."""
    out, jt, tt = runs
    for fj, ft in zip(out["j"], out["t"]):
        cj, ct = -fj["R"].T @ fj["t"], -ft["R"].T @ ft["t"]
        assert np.linalg.norm(cj - ct) < 5e-3
        assert _rot_angle(fj["R"], ft["R"]) < 1e-3
        assert abs(ft["n_mp"] - fj["n_mp"]) <= 0.02 * fj["n_mp"]
    np.testing.assert_allclose(tt.trajectory_centers(), jt.trajectory_centers(),
                               rtol=0, atol=5e-3)
    assert len(tt.trajectory) == len(jt.trajectory) == N_FRAMES


def test_threshold_and_keyframe_records_agree(runs):
    """The host-side state the next frame depends on: the FAST threshold,
    keyframe bookkeeping, and each keyframe's record in the map."""
    _, jt, tt = runs
    assert tt.threshold.t == jt.threshold.t
    assert (tt.last_kf_id, tt.last_kf_frame, tt.ref_kf_matches) == \
        (jt.last_kf_id, jt.last_kf_frame, jt.ref_kf_matches)
    jm, tm = jt.map, tt.map
    n = int(jm.n_kf)
    assert int(tm.n_kf) == n
    np.testing.assert_array_equal(tm.kf_valid.numpy(), np.asarray(jm.kf_valid))
    np.testing.assert_array_equal(tm.kf_parent.numpy(), np.asarray(jm.kf_parent))
    np.testing.assert_allclose(tm.kf_ts.numpy(), np.asarray(jm.kf_ts), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.kf_t.numpy()[:n], np.asarray(jm.kf_t)[:n], rtol=0, atol=5e-3)


def test_fallback_and_loss_match_reference(disturbed_runs):
    """Per frame the same state and keyframe decision, and inlier counts
    within 2% (f32 pose solves may flip a marginal inlier; observed equal).
    Frame JOLT takes the fallback once in both packages (the reference's
    calls counted by a wrapper); only the blank frame is a track failure."""
    kind, out, jt, tt, j_ref_calls = disturbed_runs
    lost = kind == "blank_frame"
    for i, (fj, ft) in enumerate(zip(out["j"], out["t"])):
        want = ttr.RECENTLY_LOST if (lost and i == JOLT) else ttr.OK
        assert ft["state"] == fj["state"] == want, i
        assert ft.get("kf", False) == fj.get("kf", False), i
        assert abs(ft["n_inliers"] - fj["n_inliers"]) <= 0.02 * fj["n_inliers"], i
    assert tt.stats["ref_kf_fallbacks"] == j_ref_calls == 1
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == int(lost)
    assert tt.stats["n_kf"] == jt.stats["n_kf"]
    assert tt.state == jt.state == ttr.OK


def test_fallback_and_loss_poses_agree(disturbed_runs):
    """The bounds of test_poses_and_map_agree, for the same reasons; a lost
    frame keeps the last pose in both packages."""
    _, out, jt, tt, _ = disturbed_runs
    for fj, ft in zip(out["j"], out["t"]):
        cj, ct = -fj["R"].T @ fj["t"], -ft["R"].T @ ft["t"]
        assert np.linalg.norm(cj - ct) < 5e-3
        assert _rot_angle(fj["R"], ft["R"]) < 1e-3
        assert abs(ft["n_mp"] - fj["n_mp"]) <= 0.02 * fj["n_mp"]
    np.testing.assert_allclose(tt.trajectory_centers(), jt.trajectory_centers(),
                               rtol=0, atol=5e-3)
