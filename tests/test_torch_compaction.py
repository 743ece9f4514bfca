"""Map compaction in the port against the JAX reference: `compact_map` on
the toy map of tests/test_compaction.py (its four `TestCompactMap` cases,
every field of the compacted map equal and the reference's own
assertions), and the synchronous trackers on 36 frames of bench.py's room
orbit at 320x200 with 12 keyframe and 1,024 landmark slots and dense
keyframing (a keyframe on every frame), where both compact the map again
and again.

The named exception: the reference's `Tracker._compact_map`
(orbslam3lib_tpu/tracking/tracker.py:661-699) leaves `_prev_feat_mp`, the
previous frame's feature -> landmark ids, as they were, so the next
frame's stage-1 search and local-map mask read the slots that other
landmarks moved into. The port remaps those ids through `mp_new`.
`test_reference_leaves_stale_landmark_ids` shows the fault;
`test_trackers_agree_with_the_reference_fault` runs the port with the
reference's behaviour put back and holds it to the reference on every
frame (state, keyframe decision, keyframes, compactions; centres within
1 mm); `test_port_tracks_through_compaction` holds the port as shipped to
the same acceptance as the reference's run."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.evaluation import ate_rmse  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import (fast_reference_brief, loop_config,  # noqa: E402,F401
                          orbit_frames, reference_ransac_draws,
                          reference_single_device_gba)
from torch_parity import reference_lie  # noqa: E402,F401

N_FRAMES = 36


def _toy_map(n_kf=6, n_mp=10, max_kf=8, max_mp=16, n_feat=8):
    """tests/test_compaction.py's toy map (JAX): KF k observes landmarks
    k..k+4 in its first feature slots."""
    m = jms.empty_map(max_kf=max_kf, max_mp=max_mp, n_feat=n_feat)
    rng = np.random.default_rng(0)
    for k in range(n_kf):
        xy = rng.uniform(0, 100, (n_feat, 2)).astype(np.float32)
        desc = rng.integers(0, 2, (n_feat, 256)).astype(np.int8)
        assoc = np.full(n_feat, -1, np.int32)
        for s in range(5):
            if k + s < n_mp:
                assoc[s] = k + s
        m, _ = jms.insert_keyframe(
            m, jnp.eye(3), jnp.asarray([0.0, 0.0, float(k)]), jnp.float32(k * 0.5),
            jnp.asarray(xy), jnp.zeros(n_feat, jnp.int32), jnp.asarray(desc),
            jnp.ones(n_feat, bool), jnp.asarray(assoc), jnp.zeros(n_feat, jnp.float32))
    pos = rng.uniform(-5, 5, (n_mp, 3)).astype(np.float32)
    return m._replace(
        mp_pos=m.mp_pos.at[:n_mp].set(jnp.asarray(pos)),
        mp_valid=m.mp_valid.at[:n_mp].set(True),
        mp_first_kf=m.mp_first_kf.at[:n_mp].set(jnp.arange(n_mp, dtype=jnp.int32) % 6),
        n_mp=jnp.int32(n_mp))


CASES = {
    "noop": lambda m: m,
    "culled_kfs": lambda m: m._replace(kf_valid=m.kf_valid.at[1].set(False).at[3].set(False)),
    "orphan_and_culled_mps": lambda m: m._replace(mp_valid=m.mp_valid.at[2].set(False),
                                                  kf_valid=m.kf_valid.at[5].set(False)),
    "first_kf_culled": lambda m: m._replace(kf_valid=m.kf_valid.at[0].set(False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_map_agrees(case):
    m = CASES[case](_toy_map())
    j2, jk, jp = jms.compact_map(m)
    t2, tk, tp = tms.compact_map(tms.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()}))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    got = tms.to_numpy(t2)
    for name, want in j2._asdict().items():
        assert got[name].dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got[name], np.asarray(want), err_msg=name)
    # the reference's own assertions (tests/test_compaction.py::TestCompactMap)
    kf_new, mp_new = tk.numpy(), tp.numpy()
    if case == "noop":
        assert int(t2.n_kf) == 6 and int(t2.n_mp) == 10
    if case == "culled_kfs":
        np.testing.assert_array_equal(kf_new[:6], [0, -1, 1, -1, 2, 3])
        np.testing.assert_allclose(got["kf_ts"][:4], [0.0, 1.0, 2.0, 2.5])
    if case == "orphan_and_culled_mps":
        assert mp_new[2] == -1
        obs = tms.mp_observation_count(t2).numpy()
        assert (obs[:int(t2.n_mp)] >= 1).all()
    if case == "first_kf_culled":
        first_old = np.asarray(m.mp_first_kf)
        for old in range(10):
            if mp_new[old] >= 0 and first_old[old] >= 0:
                assert got["mp_first_kf"][mp_new[old]] == kf_new[first_old[old]]


def _config(cfg_cls, rig):
    cfg = loop_config(cfg_cls, rig)
    cfg.map.max_kf = 12
    cfg.map.max_mp = 1024
    cfg.tracker.min_frames_between_kf = 1
    cfg.tracker.kf_ref_ratio = 10.0
    return cfg


def _ids(x):
    return None if x is None else np.array(x)


def _run(tr, imgs, ts, log):
    """Drive a tracker over the frames; log each compaction that freed
    slots: (frame, bindings before, bindings after, map arrays before)."""
    real = tr._compact_map
    rec = []

    def compact():
        before = _ids(tr._prev_feat_mp)
        arrays = (tms.to_numpy(tr.map) if isinstance(tr.map, tms.MapState)
                  else {k: np.asarray(v) for k, v in tr.map._asdict().items()})
        done = real()
        if done:
            log.append((len(rec), before, _ids(tr._prev_feat_mp), arrays))
        return done

    tr._compact_map = compact
    for img, stamp in zip(imgs, ts):
        res = tr.process_frame(img, float(stamp))
        rec.append((int(res["state"]), bool(res.get("kf", False)), tr.stats["n_kf"], len(log)))
    return rec


@pytest.fixture(scope="module")
def runs(fast_reference_brief):
    imgs, ts, rig = orbit_frames(N_FRAMES)
    jt = jtr.Tracker(_config(JCfg, rig), "stereo", enable_loop_closing=True, pipeline=0)
    tt = ttr.Tracker(_config(TCfg, rig), "stereo", device="cpu")
    faulty = ttr.Tracker(_config(TCfg, rig), "stereo", device="cpu")
    faulty._remap_prev_feat_mp = lambda mp_new: None    # the reference's behaviour
    logs = {"j": [], "t": [], "f": []}
    with reference_ransac_draws(), reference_single_device_gba():
        recs = {k: _run(tr, imgs, ts, logs[k]) for k, tr in
                (("j", jt), ("f", faulty), ("t", tt))}
    return recs, logs, jt, faulty, tt, ts


def test_reference_leaves_stale_landmark_ids(runs):
    """At its first compaction the reference keeps the previous frame's
    landmark ids while the landmarks move to lower slots: the next frame
    reads other landmarks. The port's bindings follow `mp_new`."""
    _, logs, _, _, _, _ = runs
    assert logs["j"] and logs["t"]
    frame, before, after, arrays = logs["j"][0]
    np.testing.assert_array_equal(after, before)                 # untouched
    mp_new = np.asarray(jms.compact_map(jms.MapState(**{
        k: jnp.asarray(v) for k, v in arrays.items()}))[2])
    bound = before[before >= 0]
    assert (mp_new[bound] != bound).any(), "no bound landmark moved"
    frame_t, before_t, after_t, arrays_t = logs["t"][0]
    mp_new_t = tms.compact_map(tms.from_numpy(arrays_t))[2].numpy()
    want = np.where(before_t >= 0, mp_new_t[np.clip(before_t, 0, None)], -1)
    np.testing.assert_array_equal(after_t, want)


def test_trackers_agree_with_the_reference_fault(runs):
    recs, logs, jt, faulty, _, _ = runs
    assert recs["f"] == recs["j"]
    assert len(logs["f"]) == len(logs["j"]) >= 1
    assert faulty.state == jt.state == ttr.OK
    assert int(faulty.map.n_kf) == int(jt.map.n_kf) <= 12
    assert int(faulty.map.n_mp) == int(jt.map.n_mp)
    np.testing.assert_allclose(faulty.trajectory_centers(), jt.trajectory_centers(),
                               rtol=0, atol=1e-3)


def test_port_tracks_through_compaction(runs):
    recs, logs, jt, _, tt, ts = runs
    assert len(logs["t"]) >= 1
    assert tt.state == ttr.OK and tt.stats["track_fail"] == 0
    assert tt.stats["n_compactions"] == len(logs["t"])
    assert int(tt.map.n_kf) <= 12 and int(tt.map.n_mp) <= 1024
    assert tt.stats["n_kf"] >= jt.stats["n_kf"]
    gt = orbit_pose_at(np.asarray(ts), period=24.0, radius=0.5)[1]
    ate_t = ate_rmse(tt.trajectory_centers(), gt)
    ate_j = ate_rmse(jt.trajectory_centers(), gt)
    assert ate_t <= 1.5 * ate_j + 0.005, (ate_t, ate_j)
    # the loop closer's and the database's ids stay inside the live slots
    lc = tt.loop_closer
    n = int(tt.map.n_kf)
    assert all(0 <= i < n and 0 <= j < n for i, j in lc.loop_edges)
    assert lc.last_loop_kf < n
    np.testing.assert_array_equal(tt.place_rec.active.numpy(), tt.map.kf_valid.numpy())
