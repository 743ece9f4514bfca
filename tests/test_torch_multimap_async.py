"""The Atlas with the mapper thread: tests/test_torch_multimap_slam.py's
frames (the 8 s orbit at 320x200; map A from frames 0-35, a 1.4 s gap in
the stamps, map B from frame 56, A's start revisited from frame 120) through
the port's `Tracker(cfg, "stereo", device="cpu", async_mapping=True)`,
where each keyframe's back end, the merge detection with it, runs on the
mapper thread. Which keyframes a busy mapper lets through depends on
timing, so the run is held to quality bounds only: one map archived and
merged back by frame 149, one map at the end, no failure and no mapper
error; the archived BoW database unchanged from its archiving to the merge;
each map's camera centres within 0.3 m of the analytic orbit (SE(3)
aligned; tests/test_torch_loop_slam.py's bound on this orbit, where
drift at 3 degrees a frame and 320x200 is large: the synchronous port
reads 0.049 m on A's 36 frames and 0.131 m on B's 84, on the CPU)."""
import numpy as np
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.evaluation import ate_rmse  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import loop_config, orbit_frames  # noqa: E402

PERIOD = 8.0
A_END, B_START, END = 36, 56, 150


def test_mapper_thread_archives_and_merges():
    imgs, ts, rig = orbit_frames(END, period=PERIOD)
    tr = ttr.Tracker(loop_config(TCfg, rig), "stereo", device="cpu", async_mapping=True)
    archived, unchanged_at_merge = [], []

    def watch_archive(real):
        def archive(map_idx, db):
            archived.append((db, db.bow_db.clone(), db.active.clone()))
            real(map_idx, db)
        return archive

    real_merge = tr.atlas.merge

    def merge(src_idx, *a):
        db, bow, active = archived[0]
        unchanged_at_merge.append(torch.equal(db.bow_db, bow)
                                  and torch.equal(db.active, active))
        real_merge(src_idx, *a)

    tr.atlas.merge = merge
    centres = {"a": [], "b": []}
    try:
        for n, i in enumerate(list(range(A_END)) + list(range(B_START, END))):
            res = tr.process_frame(imgs[i], float(ts[i]))
            if n == 0:                    # the merger is made with the first keyframe
                tr.map_merger.archive = watch_archive(tr.map_merger.archive)
            if res["state"] == ttr.OK:
                R, t = (x.numpy().astype(np.float64) for x in tr.pose)
                centres["a" if i < A_END else "b"].append((ts[i], -R.T @ t))
        tr.finish()
    finally:
        tr.shutdown_mapping()
    st = tr.stats
    assert st["n_new_maps"] == 1 and st["n_map_merges"] == 1, st
    assert tr.atlas.count_maps() == 1 and tr.map_merger.archives == []
    assert st["track_fail"] == 0 and st["mapper_errors"] == 0, tr.errors
    assert len(archived) == 1 and unchanged_at_merge == [True]
    for seg in ("a", "b"):
        stamp = np.asarray([c[0] for c in centres[seg]])
        est = np.stack([c[1] for c in centres[seg]])
        assert ate_rmse(est, orbit_pose_at(stamp, period=PERIOD, radius=0.5)[1]) < 0.3, seg
