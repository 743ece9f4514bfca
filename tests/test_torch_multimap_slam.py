"""The Atlas end to end: a lost map is archived and merged back. The port's
`Tracker(cfg, "stereo", device="cpu")` against the JAX reference's
`Tracker(cfg, "stereo", enable_loop_closing=True, pipeline=0)` on the 8 s
orbit at 320x200 (`torch_parity.loop_config`, 120 frames a revolution):
frames 0-35 build map A (more than 10 keyframes), then the stamps jump
from frame 35 to frame 56 (1.4 s, over the 1 s guard), so both trackers
archive A in their Atlas and initialise map B at frame 56; at frame 120
the orbit is back at A's start and the map merger welds A into B.

Both packages' RANSACs draw the reference's hypotheses. Checked: per frame
the same state, keyframe decision, keyframe count, maps spawned and
merged; the spawn at frame 56 and the merge at frame 120; one map at the
end; camera centres within 0.5 mm and keyframe poses within 0.5 mm /
0.5 mrad (tests/test_torch_loop_slam.py's tolerances), with a named
exception for the welding BA's archived side; and the merged map's
keyframes, A's among them in B's world, on the analytic orbit.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.mapping import loop_closing as jlc  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.evaluation import ate_rmse, umeyama_alignment  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at  # noqa: E402
from orbslam3lib_tpu_torch.mapping import loop_closing as tlc  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import (fast_reference_brief, loop_config,  # noqa: E402,F401
                          orbit_frames, reference_ransac_draws,
                          reference_single_device_gba)

PERIOD = 8.0
A_END, B_START, END = 36, 56, 128
FRAMES = list(range(A_END)) + list(range(B_START, END))


def _record_merge(tr):
    """Keep (B's keyframe count, A's valid keyframes) of the merge in
    `tr.merge_block`: where merge_into appends A's keyframes."""
    real = tr.atlas.merge

    def merge(src_idx, *a):
        tr.merge_block = (int(tr.atlas.current_map.n_kf),
                          int(np.asarray(tr.atlas.maps[src_idx].kf_valid).sum()))
        real(src_idx, *a)

    tr.atlas.merge = merge


def _record_weld(mp, cls, out):
    """Keep each welding BA's (kf_cur, kf_old) in `out`."""
    real = cls._welding_ba

    def weld(self, atlas, kf_cur, kf_old, cam_params):
        out.append((kf_cur, kf_old))
        return real(self, atlas, kf_cur, kf_old, cam_params)

    mp.setattr(cls, "_welding_ba", weld)


@pytest.fixture(scope="module")
def runs(fast_reference_brief):
    imgs, ts, rig = orbit_frames(END, period=PERIOD)
    jt = jtr.Tracker(loop_config(JCfg, rig), "stereo", enable_loop_closing=True,
                     pipeline=0)
    tt = ttr.Tracker(loop_config(TCfg, rig), "stereo", device="cpu")
    rec = {"j": [], "t": []}
    origin_a = {}
    for tr in (jt, tt):
        _record_merge(tr)
        tr.welds = []
    with reference_ransac_draws(), reference_single_device_gba(), \
            pytest.MonkeyPatch.context() as mp:
        _record_weld(mp, jlc.MapMerger, jt.welds)
        _record_weld(mp, tlc.MapMerger, tt.welds)
        for i in FRAMES:
            for key, tr in (("j", jt), ("t", tt)):
                if i == B_START:
                    origin_a[key] = tr._ts_origin
                res = tr.process_frame(imgs[i], float(ts[i]))
                rec[key].append((i, res["state"], bool(res.get("kf", False)),
                                 int(tr.map.n_kf), tr.stats["n_new_maps"],
                                 tr.stats["n_map_merges"]))
    return rec, jt, tt, ts, origin_a


def test_same_spawn_and_merge(runs):
    rec, jt, tt, _, _ = runs
    assert rec["t"] == rec["j"]
    spawn = [r[0] for r in rec["j"] if r[4] == 1][0]
    merge = [r[0] for r in rec["j"] if r[5] == 1][0]
    assert (spawn, merge) == (B_START, 120)
    assert tt.stats["n_new_maps"] == jt.stats["n_new_maps"] == 1
    assert tt.stats["n_map_merges"] == jt.stats["n_map_merges"] == 1
    assert tt.atlas.count_maps() == jt.atlas.count_maps() == 1
    assert tt.map_merger.archives == [] and jt.map_merger.archives == []
    assert int(tt.map.n_kf) == int(jt.map.n_kf)
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 0


def _weld_block(tr):
    """Slots of the archived map's keyframes inside the welding BA's window
    (the old candidate and up to 3 on each side, within A's block)."""
    first_a, n_a = tr.merge_block
    (_, k), = tr.welds
    return np.arange(max(first_a, k - 3), min(first_a + n_a, k + 4))


def _centres(m, n):
    R, t = np.asarray(m.kf_R)[:n], np.asarray(m.kf_t)[:n]
    return -np.einsum("kji,kj->ki", R, t), R


def test_poses_agree_after_the_merge(runs):
    """Camera centres and keyframe poses within 0.5 mm / 0.5 mrad.

    Named exception, a fault of the reference (ROADMAP queue 3): its
    welding BA holds only the current keyframe fixed, so the archived
    map's keyframes in the weld window, which share no landmark with the
    current map's, move by a free rigid motion; the port also holds the
    old candidate fixed. Those keyframes are held to the reference's up to
    one rigid motion (0.5 mm after aligning them), and the frames tracked
    after the merge, which see their landmarks, to 5 mm."""
    _, jt, tt, _, _ = runs
    blk = _weld_block(jt)
    assert list(blk) == list(_weld_block(tt)) and len(blk) >= 2
    n = int(jt.map.n_kf)
    jv = np.asarray(jt.map.kf_valid)[:n]
    np.testing.assert_array_equal(tt.map.kf_valid.numpy()[:n], jv)
    rest = np.setdiff1d(np.flatnonzero(jv), blk)
    cj, Rj = _centres(jt.map, n)
    ct, Rt = _centres(tt.map, n)
    np.testing.assert_allclose(ct[rest], cj[rest], rtol=0, atol=5e-4)
    skew = np.einsum("kji,kjl->kil", Rj[rest], Rt[rest])
    ang = 0.5 * np.stack([skew[:, 2, 1] - skew[:, 1, 2], skew[:, 0, 2] - skew[:, 2, 0],
                          skew[:, 1, 0] - skew[:, 0, 1]], 1)
    assert np.abs(ang).max() < 5e-4
    _, R_al, t_al = umeyama_alignment(ct[blk], cj[blk])
    np.testing.assert_allclose(ct[blk] @ R_al.T + t_al, cj[blk], rtol=0, atol=5e-4)
    traj_t, traj_j = tt.trajectory_centers(), jt.trajectory_centers()
    n_before = FRAMES.index(120) + 1
    np.testing.assert_allclose(traj_t[:n_before], traj_j[:n_before], rtol=0, atol=5e-4)
    np.testing.assert_allclose(traj_t[n_before:], traj_j[n_before:], rtol=0, atol=5e-3)


def test_merged_map_on_the_orbit(runs):
    """The merged map's keyframes against the analytic orbit at their
    stamps: B's keyframes are stamped from B's first frame, A's (appended
    at B's keyframe count when the merge ran) from A's; one rigid alignment
    for all of them. The port's no worse than the reference's + 2 mm (its
    weld, the named exception above, differs), under
    tests/test_torch_loop_slam.py's 0.3 m on this orbit."""
    _, jt, tt, _, origin_a = runs
    ate = {}
    for key, tr in (("t", tt), ("j", jt)):
        m = {k: np.asarray(getattr(tr.map, k)) for k in ("kf_valid", "kf_R", "kf_t", "kf_ts")}
        v = m["kf_valid"]
        first_a, n_a = tr.merge_block
        slots = np.arange(len(v))
        origin = np.where((slots >= first_a) & (slots < first_a + n_a), origin_a[key],
                          tr._ts_origin)
        est = -np.einsum("kji,kj->ki", m["kf_R"][v], m["kf_t"][v])
        gt = orbit_pose_at(m["kf_ts"][v].astype(np.float64) + origin[v], period=PERIOD,
                           radius=0.5)[1]
        ate[key] = ate_rmse(est, gt)
    assert ate["t"] <= ate["j"] + 2e-3 and ate["t"] < 0.3, ate
