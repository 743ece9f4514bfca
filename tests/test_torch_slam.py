"""The slice as a whole with its back end: synchronous stereo SLAM without
loop closing (`Tracker.process_frame`, local mapping and local BA on every
keyframe), the port against the JAX reference's `Tracker(cfg, "stereo",
enable_loop_closing=False, pipeline=0)` on the same frames of bench.py's
room orbit at a reduced size (320x200, 4 levels, 256 keypoints, 16 KF /
2048 MP map, BA window 3 + 2 with 1024 points, a keyframe every 2 frames:
8 keyframes in 16 frames, 6 local BAs, landmark and keyframe culling).

Also the loss timeout: lost for more than 5 s, both packages return to
NOT_INITIALIZED on the same frame and initialise again on the next textured
frame; a map of more than 10 keyframes is archived in the Atlas first.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.mapping import local_mapping as tlm  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import (backend_config, fast_reference_brief,  # noqa: E402,F401
                          orbit_frames, reference_ransac_draws,
                          reference_single_device_gba)

N_FRAMES = 16


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _pose(tr):
    R, t = tr.pose
    if isinstance(R, torch.Tensor):
        R, t = R.numpy(), t.numpy()
    return np.asarray(R, np.float64), np.asarray(t, np.float64)


def _drive(trackers, frames):
    """Feed (img, ts) to every tracker in turn; per tracker, one record per
    frame: the result, the pose (None before initialisation), n_mp, n_kf."""
    out = [[] for _ in trackers]
    for img, stamp in frames:
        for rec, tr in zip(out, trackers):
            res = tr.process_frame(img, float(stamp))
            rec.append(dict(res, pose=_pose(tr) if tr.pose is not None else None,
                            n_mp=int(tr.map.n_mp), n_kf=int(tr.map.n_kf)))
    return out


@pytest.fixture(scope="module")
def runs(fast_reference_brief):
    imgs, ts, rig = orbit_frames(N_FRAMES)
    jt = jtr.Tracker(backend_config(JCfg, rig), "stereo",
                     enable_loop_closing=False, pipeline=0)
    tt = ttr.Tracker(backend_config(TCfg, rig), "stereo", device="cpu",
                     enable_loop_closing=False)
    culled = []
    real = tlm.cull_mappoints

    def counting(m, kid):
        n0 = int(m.n_mp)
        m = real(m, kid)
        culled.append(n0 - int(m.n_mp))
        return m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlm, "cull_mappoints", counting)
        rj, rt = _drive([jt, tt], zip(imgs, ts))
    return rj, rt, jt, tt, culled


def test_back_end_ran(runs):
    """>= 6 keyframes, local mapping on each after the first, local BA on
    each from the third, landmarks culled, a keyframe culled."""
    _, _, jt, tt, culled = runs
    st = tt.stats
    assert st["n_kf"] == jt.stats["n_kf"] >= 6
    assert st["n_mapping_steps"] == st["n_kf"] - 1
    assert st["n_local_ba"] == st["n_kf"] - 2 >= 2
    assert sum(culled) > 0
    assert int(tt.map.kf_valid.sum()) < st["n_kf"]


def test_per_frame_state_and_pose(runs):
    """Per frame: the same state and keyframe decision, inliers within 2%
    (f32 pose solves may flip a marginal inlier), camera centre within 5 mm
    and rotation within 1 mrad (f32 BA and pose solves summed in another
    order), landmark count within 2%."""
    rj, rt, _, _, _ = runs
    for i, (fj, ft) in enumerate(zip(rj, rt)):
        assert ft["state"] == fj["state"] == ttr.OK, i
        assert ft.get("kf", False) == fj.get("kf", False), i
        assert abs(ft["n_inliers"] - fj["n_inliers"]) <= 0.02 * fj["n_inliers"], i
        (Rj, tj), (Rt, t_) = fj["pose"], ft["pose"]
        assert np.linalg.norm(Rj.T @ tj - Rt.T @ t_) < 5e-3, i
        assert _rot_angle(Rj, Rt) < 1e-3, i
        assert abs(ft["n_mp"] - fj["n_mp"]) <= 0.02 * fj["n_mp"], i


def test_final_map_agrees(runs):
    """kf_valid and kf_parent equal; n_mp within 2% and kf_mp entries at
    least 98% equal (one marginal match could change a spawn or a fusion);
    keyframe poses within 5 mm. Observed: all equal, poses within 1e-6 m."""
    _, _, jt, tt, _ = runs
    jm, tm = jt.map, tt.map
    np.testing.assert_array_equal(tm.kf_valid.numpy(), np.asarray(jm.kf_valid))
    np.testing.assert_array_equal(tm.kf_parent.numpy(), np.asarray(jm.kf_parent))
    assert abs(int(tm.n_mp) - int(jm.n_mp)) <= 0.02 * int(jm.n_mp)
    n = int(jm.n_kf)
    assert (tm.kf_mp.numpy()[:n] == np.asarray(jm.kf_mp)[:n]).mean() >= 0.98
    np.testing.assert_allclose(tm.kf_t.numpy()[:n], np.asarray(jm.kf_t)[:n], rtol=0, atol=5e-3)
    np.testing.assert_allclose(tt.trajectory_centers(), jt.trajectory_centers(),
                               rtol=0, atol=5e-3)


N_TEXTURED, N_BLANK, BLANK_DT = 6, 7, 0.9


def _lost_sequence(imgs, ts, n_textured=N_TEXTURED):
    """n_textured orbit frames, then N_BLANK flat grey frames BLANK_DT apart
    (under the 1 s timestamp guard, 5.4 s in all), then two orbit frames."""
    frames = list(zip(imgs[:n_textured], ts[:n_textured]))
    t = ts[n_textured - 1]
    for _ in range(N_BLANK):
        t += BLANK_DT
        frames.append((np.full_like(imgs[0], 90), t))
    for img in imgs[n_textured:n_textured + 2]:
        t += BLANK_DT
        frames.append((img, t))
    return frames


def test_loss_timeout_matches_reference(fast_reference_brief):
    """Both packages: the first blank frame enters RECENTLY_LOST (its BoW
    query finds no candidate, so the reference's relocalisation does not
    run), the 7th (5.4 s later) returns to NOT_INITIALIZED, and the next
    textured frame initialises again.

    Named exception, a fault of the reference (ROADMAP queue 3): with 10
    keyframes or fewer it only resets the tracking state and keeps the old
    map, so its new initial keyframe joins the stale map. The port resets
    the active map, as ORB-SLAM3's ResetActiveMap does: its map starts over
    with one keyframe."""
    imgs, ts, rig = orbit_frames(N_TEXTURED + 2)
    jt = jtr.Tracker(backend_config(JCfg, rig), "stereo",
                     enable_loop_closing=False, pipeline=0)
    tt = ttr.Tracker(backend_config(TCfg, rig), "stereo", device="cpu",
                     enable_loop_closing=False)
    rj, rt = _drive([jt, tt], _lost_sequence(imgs, ts))
    states = [(fj["state"], ft["state"]) for fj, ft in zip(rj, rt)]
    want = ([ttr.OK] * N_TEXTURED + [ttr.RECENTLY_LOST] * (N_BLANK - 1)
            + [ttr.NOT_INITIALIZED] + [ttr.OK] * 2)
    assert states == [(s, s) for s in want]
    reinit = N_TEXTURED + N_BLANK
    assert rj[reinit].get("init") and rt[reinit].get("init")
    n_kf_lost = rt[N_TEXTURED - 1]["n_kf"]
    assert n_kf_lost == rj[N_TEXTURED - 1]["n_kf"] >= 2
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == N_BLANK
    # the named exception
    assert rj[reinit]["n_kf"] == n_kf_lost + 1
    assert rt[reinit]["n_kf"] == 1
    assert (tt.stats["n_resets"], tt.stats["n_new_maps"]) == (1, 0)


def test_loss_timeout_large_map_starts_a_new_one(fast_reference_brief):
    """With more than 10 keyframes both packages archive the lost map in
    their Atlas (CreateMapInAtlas) on the same frame and initialise a new
    one on the next textured frame: two maps, the new one current with its
    first keyframe, and the archived map equal to the reference's (integer
    and bool fields equal, f32 fields within 5 mm, as `test_final_map_agrees`
    holds the keyframe poses), its BoW database frozen in the map merger."""
    imgs, ts, rig = orbit_frames(26)
    jt = jtr.Tracker(backend_config(JCfg, rig), "stereo", enable_loop_closing=True,
                     pipeline=0)
    tt = ttr.Tracker(backend_config(TCfg, rig), "stereo", device="cpu")
    frames = _lost_sequence(imgs, ts, 24)
    with reference_ransac_draws(), reference_single_device_gba():
        rj, rt = _drive([jt, tt], frames)
    assert int(tt.atlas.maps[0].n_kf) > 10
    states = [(fj["state"], ft["state"]) for fj, ft in zip(rj, rt)]
    assert [s for s, _ in states] == [s for _, s in states]
    assert states[24 + N_BLANK - 1] == (ttr.NOT_INITIALIZED,) * 2
    assert states[24 + N_BLANK] == (ttr.OK,) * 2
    for tr in (jt, tt):
        assert (tr.stats["n_resets"], tr.stats["n_new_maps"]) == (0, 1)
        assert tr.atlas.count_maps() == 2 and tr.atlas.current == 1
        assert int(tr.map.n_kf) == 1                  # the new map's first keyframe
        assert [a["map_idx"] for a in tr.map_merger.archives] == [0]
    tm, jm = tt.atlas.maps[0], jt.atlas.maps[0]
    n = int(jm.n_kf)
    assert int(tm.n_kf) == n
    np.testing.assert_array_equal(tm.kf_valid.numpy(), np.asarray(jm.kf_valid))
    np.testing.assert_array_equal(tm.kf_parent.numpy(), np.asarray(jm.kf_parent))
    assert (tm.kf_mp.numpy()[:n] == np.asarray(jm.kf_mp)[:n]).mean() >= 0.98
    np.testing.assert_allclose(tm.kf_t.numpy()[:n], np.asarray(jm.kf_t)[:n], rtol=0, atol=5e-3)
    jdb, tdb = jt.map_merger.archives[0]["db"], tt.map_merger.archives[0]["db"]
    np.testing.assert_array_equal(tdb.active.numpy(), np.asarray(jdb.active))
