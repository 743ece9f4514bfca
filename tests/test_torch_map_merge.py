"""The port's map merge (`mapping/loop_closing.py`: `match_kf_landmarks_cross`,
`merge_world_sim3`, `MapMerger`) against the JAX reference's on
tests/test_map_merge.py's two ring maps (map B in a world turned 0.3 rad,
shifted and scaled 1.25 from A's; B's last keyframe revisits A's first),
built JAX-free in `torch_parity.merge_ring_maps`, with the reference's
RANSAC draws in both (`torch_parity.reference_ransac_draws`).

Tolerances: the cross match's indices and masks equal and its camera-frame
points within 1e-5 m (one rigid transform in f32); `merge_world_sim3`
within 1e-5; after a merge (RANSAC, 10 Gauss-Newton steps of OptimizeSim3
and the welding BA's LM, in another summation order) the merged map's
integer and bool fields equal and its poses and landmarks within 1e-3.
The port's welding BA also holds the old candidate fixed (the reference's
leaves the archived side unanchored: `test_welding_ba_anchor_reference_fault`);
on these noise-free maps the reference's free side stays within 1e-3.

Also the tracker's three decisions where the Atlas meets the threads, the
pipelined chain and compaction (tracker.py's module docstring), each on
these maps: the chain and the last keyframe survive a merge untouched; a
merge with two archives (the reference's `remove_bad_maps` fault) leaves the
other archive naming its map, through a later compaction; and a spawn from
the tracker's thread while keyframes of the old map wait for the mapper
thread skips them and writes nothing into the archived database."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.mapping import loop_closing as jlc  # noqa: E402
from orbslam3lib_tpu.models import atlas as jat  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms  # noqa: E402
from orbslam3lib_tpu.models import vocabulary as jvb  # noqa: E402
from orbslam3lib_tpu.tracking.reloc import PlaceRecognition as JPR  # noqa: E402
from orbslam3lib_tpu.utils import lie as jlie  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.mapping import loop_closing as tlc  # noqa: E402
from orbslam3lib_tpu_torch.models import atlas as tat  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402
from orbslam3lib_tpu_torch.models import vocabulary as tvb  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402
from orbslam3lib_tpu_torch.tracking.reloc import make_place_recognition  # noqa: E402

from torch_parity import RING_CAM, merge_ring_maps, reference_ransac_draws  # noqa: E402

POS_TOL = 1e-5
MERGED_TOL = 1e-3


@pytest.fixture(scope="module")
def maps():
    return merge_ring_maps()


def to_jax(arr):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in arr.items()})


def ring_cfg(cfg_cls):
    """The ring maps' camera (640x400, f 300) for either package."""
    cfg = cfg_cls()
    cfg.camera.fx = cfg.camera.fy = 300.0
    cfg.camera.cx, cfg.camera.cy = 320.0, 200.0
    cfg.camera.width, cfg.camera.height = 640, 400
    return cfg


def jax_db(voc, m):
    db = JPR(voc, max_kf=32)
    for i in range(int(m.n_kf)):
        db.add(i, m.kf_desc[i], m.kf_feat_valid[i])
    return db


def torch_db(voc, m):
    db = make_place_recognition(voc, 32)
    for i in range(int(m.n_kf)):
        db.add(i, m.kf_desc[i], m.kf_feat_valid[i])
    return db


def test_cross_match_matches_reference(maps):
    a, b, _, _, _ = maps
    ja, jb = to_jax(a), to_jax(b)
    ta, tb = tms.from_numpy(a), tms.from_numpy(b)
    jo = jlc.match_kf_landmarks_cross(jb, jnp.int32(3), ja, jnp.int32(0))
    to = tlc.match_kf_landmarks_cross(tb, 3, ta, 0)
    np.testing.assert_array_equal(to[4].numpy(), np.asarray(jo[4]))
    v = to[4].numpy()
    assert v.sum() > 40
    np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]))
    np.testing.assert_array_equal(to[3].numpy()[v], np.asarray(jo[3])[v])   # matched slots
    for k in (0, 1):
        np.testing.assert_allclose(to[k].numpy()[v], np.asarray(jo[k])[v],
                                   rtol=0, atol=POS_TOL)


def test_merge_world_sim3_matches_reference():
    rng = np.random.default_rng(9)
    args = []
    for _ in range(3):
        xi = (rng.normal(size=6) * 0.4).astype(np.float32)
        R, t = (np.array(x) for x in jlie.se3_exp(jnp.asarray(xi)))
        args.append((R, t))
    (Rc, tc), (R12, t12), (Ro, to_) = args
    s12 = np.float32(1.3)
    jo = jlc.merge_world_sim3(*(jnp.asarray(x) for x in (Rc, tc, R12, t12, s12, Ro, to_)))
    tout = tlc.merge_world_sim3(*(torch.from_numpy(np.asarray(x))
                                  for x in (Rc, tc, R12, t12, s12, Ro, to_)))
    for x, y in zip(tout, jo):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=POS_TOL)


def _mergers(maps, consistency_needed):
    a, b, _, _, descs = maps
    jvoc = jvb.train_vocabulary(descs, k=4, depth=3)
    tvoc = tvb.train_vocabulary(descs, k=4, depth=3)
    ja = jat.Atlas(32, 1024, 160)
    ja.maps, ja.bad, ja.current = [to_jax(a), to_jax(b)], [False, False], 1
    ta = tat.Atlas(32, 1024, 160)
    ta.maps, ta.bad, ta.current = [tms.from_numpy(a), tms.from_numpy(b)], [False, False], 1
    jm = jlc.MapMerger(JCfg(), consistency_needed=consistency_needed)
    jm.archive(0, jax_db(jvoc, ja.maps[0]))
    tm = tlc.MapMerger(ring_cfg(TCfg), consistency_needed=consistency_needed)
    tm.archive(0, torch_db(tvoc, ta.maps[0]))
    return ja, jm, ta, tm


@pytest.mark.parametrize("consistency_needed", [1, 3])
def test_map_merger_matches_reference(maps, consistency_needed):
    """The same decision on every keyframe: map B's keyframe 0 (no overlap)
    never merges; keyframe 3 merges once it has been seen
    `consistency_needed` times in a row. Then the merged maps agree."""
    ja, jm, ta, tm = _mergers(maps, consistency_needed)
    jcam = jnp.asarray(RING_CAM)
    tcam = torch.from_numpy(RING_CAM)
    seq = [0] + [3] * consistency_needed
    with reference_ransac_draws():
        for kf in seq:
            jd = jm.on_keyframe(ja, kf, jcam)
            td = tm.on_keyframe(ta, kf, tcam)
            assert td == jd
            assert tm.count == jm.count and tm.consistent == jm.consistent
    assert td and tm.n_merges == jm.n_merges == 1
    assert ta.count_maps() == ja.count_maps() == 1 and tm.archives == []
    assert tm.last_merge["kf_old"] == jm.last_merge["kf_old"] == 4
    tmap, jmap = ta.current_map, ja.current_map
    for k in tms.FIELDS:
        x, y = getattr(tmap, k).numpy(), np.asarray(getattr(jmap, k))
        if x.dtype == np.float32:
            np.testing.assert_allclose(x, y, rtol=0, atol=MERGED_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_merged_geometry(maps):
    """tests/test_map_merge.py's check on the port: A's landmarks land at
    their place in B's world, p_B = s R_g p_A + t_g, within 5 cm."""
    _, _, G, pts, descs = maps
    R_g, t_g, s_g = G
    _, _, ta, tm = _mergers(maps, 1)
    with reference_ransac_draws():
        assert tm.on_keyframe(ta, 3, torch.from_numpy(RING_CAM))
    m = ta.current_map
    assert int(m.n_kf) == 9
    expect_a = pts @ R_g.T * s_g + t_g
    pos, desc = m.mp_pos.numpy(), m.mp_desc.numpy()
    n_from_a = 0
    for j in np.flatnonzero(m.mp_valid.numpy()):
        p = int(np.argmin((desc[j][None, :] != descs).sum(1)))
        err_a, err_b = (np.linalg.norm(pos[j] - e[p]) for e in (expect_a, pts))
        assert min(err_a, err_b) < 0.05
        n_from_a += err_a < err_b
    assert n_from_a > 100


def test_merge_refused_when_the_candidate_does_not_fit(maps):
    """Map B with exactly its 4 keyframe slots: A's candidate keyframe would
    land at id 4, past B's last slot, so `merge_into` would drop it and the
    welding BA would lose its anchor on the archived side. The merger
    passes every gate, makes no merge and keeps the archive; the maps are
    untouched."""
    a, b, _, _, descs = maps
    b4 = {k: (v[:4] if k.startswith("kf_") else v) for k, v in b.items()}
    assert int(b4["n_kf"]) == 4 and b4["kf_valid"].all()
    tvoc = tvb.train_vocabulary(descs, k=4, depth=3)
    ta = tat.Atlas(32, 1024, 160)
    ta.maps, ta.bad, ta.current = [tms.from_numpy(a), tms.from_numpy(b4)], [False, False], 1
    tm = tlc.MapMerger(ring_cfg(TCfg), consistency_needed=1)
    tm.archive(0, torch_db(tvoc, ta.maps[0]))
    with reference_ransac_draws():
        assert not tm.on_keyframe(ta, 3, torch.from_numpy(RING_CAM))
    assert tm.count == 1 and tm.consistent == (0, 0)  # every gate before the fit passed
    assert ta.count_maps() == 2 and len(tm.archives) == 1 and tm.n_merges == 0
    for m, arr in zip(ta.maps, (a, b4)):
        for k in tms.FIELDS:
            np.testing.assert_array_equal(getattr(m, k).numpy(), arr[k], err_msg=k)


def test_inertial_merge_raises():
    mm = tlc.MapMerger(TCfg())
    mm.inertial = False
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: IMU"):
        mm.inertial = True


def _ring_tracker(maps, async_mapping=False):
    """A port tracker on the CPU holding the ring maps: A archived (its
    database in the merger), B current with its own live database, the
    last keyframe B's 3."""
    a, b, _, _, descs = maps
    tr = ttr.Tracker(ring_cfg(TCfg), "stereo", device="cpu", async_mapping=async_mapping)
    voc = tvb.train_vocabulary(descs, k=4, depth=3)
    tr.atlas.maps = [tms.from_numpy(a), tms.from_numpy(b)]
    tr.atlas.bad, tr.atlas.current = [False, False], 1
    tr.place_rec = torch_db(voc, tr.map)
    tr.map_merger = tlc.MapMerger(tr.cfg, consistency_needed=1)
    tr.map_merger.archive(0, torch_db(voc, tr.atlas.maps[0]))
    tr._n_kf_host, tr.last_kf_id, tr.state = 4, 3, ttr.OK
    tr.pose = (tr.map.kf_R[3].clone(), tr.map.kf_t[3].clone())
    tr.vel = tr._eye_pose()
    return tr


def test_merge_keeps_the_chain(maps):
    """A merge on keyframe 3 (the last one): the pipelined chain is the same
    object afterwards, keyframe 3's pose is unchanged (the welding BA holds
    it), and the tracker's pose is that keyframe's; the host's keyframe
    count and the live database cover both maps."""
    tr = _ring_tracker(maps)
    chain = (tr.pose[0], tr.pose[1], *tr._eye_pose(),
             torch.full((160,), -1, dtype=torch.int32), torch.zeros(160))
    tr._chain = chain
    R3, t3 = tr.map.kf_R[3].clone(), tr.map.kf_t[3].clone()
    with reference_ransac_draws():
        tr._detect_merge(3)
    assert tr.stats["n_map_merges"] == 1 and tr.atlas.count_maps() == 1
    assert tr._chain is chain
    assert torch.equal(tr.map.kf_R[3], R3) and torch.equal(tr.map.kf_t[3], t3)
    assert torch.equal(tr.pose[0], R3) and torch.equal(tr.pose[1], t3)
    assert tr._n_kf_host == 9 and int(tr.place_rec.active.sum()) == 9
    assert tr.loop_closer is None or tr.loop_closer.pr is tr.place_rec


def test_two_archives_then_compaction(maps):
    """Maps [A, C, B], B current, A and C archived (C from far along the
    ring): the merge welds A in, C's archive now names index 0, B stays
    current at index 1 (the reference raises here, test_torch_atlas.py);
    a compaction of B afterwards leaves the archive naming C."""
    a, b, _, _, descs = maps
    c_arr = merge_ring_maps(thetas_a=(4.2, 4.6))[0]
    tr = _ring_tracker(maps)
    voc = tr.place_rec.voc
    m_c = tms.from_numpy(c_arr)
    tr.atlas.maps.insert(1, m_c)
    tr.atlas.bad, tr.atlas.current = [False] * 3, 2
    tr.map_merger.archive(1, torch_db(voc, m_c))
    with reference_ransac_draws():
        tr._detect_merge(3)
    mm = tr.map_merger
    assert tr.atlas.count_maps() == 2 and tr.atlas.current == 1
    assert [x["map_idx"] for x in mm.archives] == [0]
    assert tr.atlas.maps[0] is m_c
    tr.map.kf_valid[1] = False                        # a culled keyframe to reclaim
    assert tr._compact_map()
    assert tr.atlas.maps[mm.archives[0]["map_idx"]] is m_c
    assert tr.atlas.current == 1 and int(tr.map.n_kf) == 8


def test_spawn_skips_queued_keyframes(maps):
    """The mapper thread: a spawn from the tracker's thread, with keyframes
    of the old map still queued, archives the live database; the mapper
    skips those ids (an older map epoch) and nothing writes into the
    archived database afterwards."""
    tr = _ring_tracker(maps, async_mapping=True)
    try:
        tr.map_merger.archives = []
        tr._n_kf_host = 11
        with tr._map_lock:                            # the mapper waits
            tr._map_queue.put((tr._map_epoch, 2))
            tr._map_queue.put((tr._map_epoch, 3))
            live = tr.place_rec
            bow, active = live.bow_db.clone(), live.active.clone()
            tr._new_map()
        tr.wait_mapping_idle()
        assert tr.stats["n_new_maps"] == 1 and tr.atlas.count_maps() == 3
        assert tr.map_merger.archives[0]["db"] is live
        assert tr.map_merger.archives[0]["map_idx"] == 1
        assert tr.stats["n_mapping_steps"] == 0 and tr.stats["mapper_errors"] == 0
        assert torch.equal(live.bow_db, bow) and torch.equal(live.active, active)
        assert tr.place_rec is not live and int(tr.map.n_kf) == 0
    finally:
        tr.shutdown_mapping()


def test_welding_ba_anchor_reference_fault(maps):
    """Named exception, a fault of the reference (ROADMAP queue 3): its
    welding BA holds only the current keyframe fixed. The archived map's
    keyframes in the window observe none of the current map's landmarks
    (no seam fusion), so that side has no anchor and moves by a free rigid
    motion. Shown on the reference's window: its archived side is not
    fixed and shares no landmark with the current side. The port holds the
    old candidate fixed as well."""
    from orbslam3lib_tpu.mapping import map_ba as jmb
    ja, jm, ta, tm = _mergers(maps, 1)
    seen = {}

    def capture(key, real):
        def f(m, ids, fixed, *a, **k):
            seen[key] = (np.asarray(ids).copy(), np.asarray(fixed).copy(),
                         np.asarray(m.kf_mp).copy())
            return real(m, ids, fixed, *a, **k)
        return f

    with reference_ransac_draws(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmb, "map_window_ba", capture("j", jmb.map_window_ba))
        mp.setattr(tlc, "map_window_ba", capture("t", tlc.map_window_ba))
        assert jm.on_keyframe(ja, 3, jnp.asarray(RING_CAM))
        assert tm.on_keyframe(ta, 3, torch.from_numpy(RING_CAM))
    n_b, kf_old = 4, jm.last_merge["kf_old"]
    for key in ("j", "t"):
        ids, fixed, kf_mp = seen[key]
        sel = ids >= 0
        old_side = sel & (ids >= n_b)
        cur_side = sel & (ids < n_b)
        assert old_side.any() and cur_side.any()
        lm = [set(kf_mp[k][kf_mp[k] >= 0].tolist()) for k in ids]
        shared = set().union(*(lm[i] for i in np.flatnonzero(old_side))) & \
            set().union(*(lm[i] for i in np.flatnonzero(cur_side)))
        assert not shared                                  # two separate blocks
        assert fixed[ids == 3].all()                       # the current keyframe
        fixed_old = set(ids[old_side & fixed].tolist())
        assert fixed_old == (set() if key == "j" else {kf_old})
