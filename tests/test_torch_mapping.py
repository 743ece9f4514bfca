"""The per-keyframe back end of the port against the JAX reference, module
by module, on maps from a real run: the JAX tracker with its back end runs
13 frames of the small orbit (a keyframe every 2 frames) and each
keyframe's map is kept as it stood before its `_mapping_pipeline`;
`map_state.from_numpy` carries it into the port. The map of keyframe 6 is
the main case: there local mapping culls landmarks and a keyframe, and
triangulation binds two new landmarks to one feature of a neighbour (a
scatter with a duplicate index). Each test runs the reference's function
and the port's on the same map.

Tolerances: integer and boolean fields (kf_mp, mp_valid, kf_valid,
kf_parent, n_mp, neighbour ids, masks) equal; float fields within 1e-5
(the same f32 arithmetic, summed in another order by einsum, index_add_
and matmul); after local BA (ten LM iterations) poses and points within
1e-4, as in test_torch_local_ba.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.mapping import local_mapping as jlm, loop_closing as jlc  # noqa: E402
from orbslam3lib_tpu.mapping import map_ba as jmb  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms, vocabulary as jvb  # noqa: E402
from orbslam3lib_tpu.tracking import matching as jmt  # noqa: E402
from orbslam3lib_tpu_torch.mapping import local_mapping as tlm, loop_closing as tlc  # noqa: E402
from orbslam3lib_tpu_torch.mapping import map_ba as tmb  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms, vocabulary as tvb  # noqa: E402

from torch_parity import (fast_reference_brief,  # noqa: E402,F401
                          reference_backend_snapshots)

KID = 6
KW = dict(cam_model=0, img_w=320, img_h=200, n_levels=4)
INT_FIELDS = ("kf_mp", "mp_valid", "kf_valid", "kf_parent", "n_mp", "n_kf",
              "mp_first_kf")


@pytest.fixture(scope="module")
def run(fast_reference_brief):
    snaps, cfg = reference_backend_snapshots(13)
    assert sorted(snaps) == list(range(1, KID + 1))
    return snaps, np.asarray(cfg.camera.params, np.float32), float(cfg.bf)


def jmap(arrays):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def np_map(m):
    if isinstance(m, tms.MapState):
        return tms.to_numpy(m)
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def assert_maps_equal(tm, jm, atol=1e-5):
    t, j = np_map(tm), np_map(jm)
    for k in j:
        if k in INT_FIELDS or j[k].dtype.kind in "biu":
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=atol, err_msg=k)


class DuplicateCounter:
    """Counts the scatter targets that several sources write, at every
    `local_mapping._last_write` of the port."""

    def __init__(self, mp):
        self.counts = []
        real = tlm._last_write

        def counting(tgt, n):
            t = tgt[tgt < n]
            self.counts.append(int(t.numel() - torch.unique(t).numel()))
            return real(tgt, n)

        mp.setattr(tlm, "_last_write", counting)


def test_covisibility_and_observation_counts(run):
    m = run[0][KID]
    np.testing.assert_array_equal(tms.covisibility(tms.from_numpy(m)).numpy(),
                                  np.asarray(jms.covisibility(jmap(m))))
    np.testing.assert_array_equal(tms.mp_observation_count(tms.from_numpy(m)).numpy(),
                                  np.asarray(jms.mp_observation_count(jmap(m))))


@pytest.mark.parametrize("kid", [3, KID])
def test_cull_mappoints(run, kid):
    m = run[0][kid]
    got = tlm.cull_mappoints(tms.from_numpy(m), kid)
    want = jlm.cull_mappoints(jmap(m), jnp.int32(kid))
    assert_maps_equal(got, want)
    if kid == KID:
        assert int(want.n_mp) < int(m["n_mp"])            # landmarks were culled


@pytest.mark.parametrize("kid", [3, KID])
def test_covisibility_windows(run, kid):
    """top_covisible at the mapper's two widths, the BA window, and the
    observed-landmark mask (with a -1 entry)."""
    m = run[0][kid]
    tm, jm = tms.from_numpy(m), jmap(m)
    for n in (10, 3):
        np.testing.assert_array_equal(tlm.top_covisible(tm, kid, n).numpy(),
                                      np.asarray(jlm.top_covisible(jm, jnp.int32(kid), n=n)))
    ids_t, fixed_t = tlm.covis_ba_window(tm, kid, n_win=3, n_fixed=2)
    ids_j, fixed_j = jlm.covis_ba_window(jm, jnp.int32(kid), n_win=3, n_fixed=2)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(fixed_t.numpy(), np.asarray(fixed_j))
    sel = np.array([kid, -1, 0], np.int32)
    np.testing.assert_array_equal(
        tlm.observed_mp_mask(tm, torch.from_numpy(sel)).numpy(),
        np.asarray(jlm.observed_mp_mask(jm, jnp.asarray(sel))))


def _culled(m, kid):
    return np_map(jlm.cull_mappoints(jmap(m), jnp.int32(kid)))


def test_triangulate_with_neighbors(run):
    """Against all ten covisible neighbours, the reference's mapper input
    (the map after landmark culling). Two features of keyframe 6 match one
    feature of a neighbour: the reference keeps the later feature's
    landmark there, and so must the port."""
    snaps, cam, _ = run
    m = _culled(snaps[KID], KID)
    nbrs = np.array(jlm.top_covisible(jmap(m), jnp.int32(KID), n=10))
    with pytest.MonkeyPatch.context() as mp:
        dup = DuplicateCounter(mp)
        got, n_t = tlm.triangulate_with_neighbors(
            tms.from_numpy(m), KID, torch.from_numpy(nbrs), torch.from_numpy(cam),
            n_levels=4, n_nbrs=10)
    want, n_j = jlm.triangulate_with_neighbors(
        jmap(m), jnp.int32(KID), jnp.asarray(nbrs), jnp.asarray(cam),
        n_levels=4, n_nbrs=10)
    assert_maps_equal(got, want)
    assert int(n_t) == int(n_j) > 0
    assert sum(dup.counts) > 0


def test_triangulate_pair(run):
    """Against each covisible neighbour alone, up to the first that spawns
    landmarks."""
    snaps, cam, _ = run
    m = _culled(snaps[KID], KID)
    for nb in np.asarray(jlm.top_covisible(jmap(m), jnp.int32(KID), n=10)):
        got, n_t = tlm.triangulate_pair(tms.from_numpy(m), KID, int(nb),
                                        torch.from_numpy(cam), n_levels=4)
        want, n_j = jlm.triangulate_pair(jmap(m), jnp.int32(KID), jnp.int32(nb),
                                         jnp.asarray(cam), n_levels=4)
        assert_maps_equal(got, want)
        assert int(n_t) == int(n_j)
        if int(n_j) > 0:
            break
    assert int(n_j) > 0


def _fuse_both(m, kf, cand, cam):
    got, n_t = tlm.fuse_into_keyframe(tms.from_numpy(m), kf, torch.from_numpy(cand.copy()),
                                      torch.from_numpy(cam), **KW)
    want, n_j = jlm.fuse_into_keyframe(jmap(m), jnp.int32(kf), jnp.asarray(cand),
                                       jnp.asarray(cam), **KW)
    assert_maps_equal(got, want)
    assert int(n_t) == int(n_j)
    return int(n_j)


def test_fuse_into_keyframe(run):
    """The mapper's four fuses, each from the map after triangulation: into
    the new keyframe (the mapper's candidate set) and its landmarks back
    into each of its three best neighbours. At least one adds or replaces
    observations."""
    snaps, cam, _ = run
    m = np_map(jlm.triangulate_with_neighbors(
        jmap(_culled(snaps[KID], KID)), jnp.int32(KID),
        jlm.top_covisible(jmap(_culled(snaps[KID], KID)), jnp.int32(KID), n=10),
        jnp.asarray(cam), n_levels=4, n_nbrs=10)[0])
    jm = jmap(m)
    nbrs = jlm.top_covisible(jm, jnp.int32(KID), n=10)
    cand = np.asarray(jlm.observed_mp_mask(jm, jnp.concatenate(
        [nbrs, jnp.int32(KID).reshape(1)])) | (jm.mp_first_kf >= KID - 8))
    n = _fuse_both(m, KID, cand, cam)
    own = np.asarray(jlm.observed_mp_mask(jm, jnp.int32(KID).reshape(1)))
    for nb in np.asarray(nbrs)[:3]:
        n += _fuse_both(m, int(nb), own, cam)
    assert n > 0


def test_fuse_duplicate_winners(run):
    """Two landmarks beat one occupant: landmark o is made to hold two
    feature slots of keyframe 6 (its own and q's), and a copy p of o takes
    over o's observations in the other keyframes. Fusing every landmark but
    o, p matches o's slot and q its own, both have more observations than o,
    and both replace o; the reference keeps the higher landmark id, and so
    must the port."""
    snaps, cam, _ = run
    m = {k: v.copy() for k, v in snaps[KID].items()}
    jm = jmap(m)
    k = KID
    n_obs = np.asarray(jms.mp_observation_count(jm))
    pm = jmt.search_by_projection(
        jm.mp_pos, jm.mp_desc, jm.mp_valid, jm.mp_normal, jm.mp_min_dist,
        jm.mp_max_dist, jm.kf_R[k], jm.kf_t[k], jnp.asarray(cam), jm.kf_xy[k],
        jm.kf_level[k], jm.kf_desc[k], jm.kf_feat_valid[k], 3.0, cam_model=0,
        img_w=320, img_h=200, th_desc=50.0, n_levels=4)
    mp_feat = np.asarray(pm.mp_feat)
    row = m["kf_mp"][k]
    own = [p for p in np.flatnonzero(mp_feat >= 0)
           if row[mp_feat[p]] == p and n_obs[p] >= 2]
    o, q = own[0], own[1]
    p = int(np.flatnonzero(~m["mp_valid"])[0])
    for f in ("mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist",
              "mp_first_kf", "mp_found", "mp_visible", "mp_valid"):
        m[f][p] = m[f][o]
    m["n_mp"] = np.int32(m["mp_valid"].sum())
    others = np.arange(m["kf_mp"].shape[0]) != k
    m["kf_mp"][others] = np.where(m["kf_mp"][others] == o, p, m["kf_mp"][others])
    m["kf_mp"][k, mp_feat[q]] = o
    cand = m["mp_valid"].copy()
    cand[o] = False
    with pytest.MonkeyPatch.context() as mpatch:
        dup = DuplicateCounter(mpatch)
        _fuse_both(m, k, cand, cam)
    assert dup.counts == [1]
    after = np_map(jlm.fuse_into_keyframe(jmap(m), jnp.int32(k), jnp.asarray(cand),
                                          jnp.asarray(cam), **KW)[0])
    assert not after["mp_valid"][o]
    assert after["kf_mp"][k, mp_feat[o]] == after["kf_mp"][k, mp_feat[q]] == max(p, q)


def test_cull_keyframes(run):
    """On the map just before the reference's keyframe culling of keyframe
    6, which retires one keyframe and re-parents its children."""
    snaps, cam, _ = run
    jm = jmap(snaps[KID])
    jm = jlm.mapping_step(jm, jnp.int32(KID), jnp.asarray(cam), do_cull_kf=False, **KW)
    protect = np.array([0, KID - 1, KID], np.int32)
    got = tlm.cull_keyframes(tms.from_numpy(np_map(jm)), torch.from_numpy(protect))
    want = jlm.cull_keyframes(jm, jnp.asarray(protect))
    assert_maps_equal(got, want)
    assert int(np.asarray(want.kf_valid).sum()) == int(np.asarray(jm.kf_valid).sum()) - 1


@pytest.mark.parametrize("kid", [2, 4, KID])
def test_mapping_step(run, kid):
    snaps, cam, _ = run
    m = snaps[kid]
    got = tlm.mapping_step(tms.from_numpy(m), kid, torch.from_numpy(cam), **KW)
    want = jlm.mapping_step(jmap(m), jnp.int32(kid), jnp.asarray(cam), **KW)
    assert_maps_equal(got, want)


def test_mapper_step_fused(run):
    """BoW add + mapping_step and the 16-float pack, without the probe and
    with it (after the keyframes before it entered the database, the
    previous consistent candidate 2): maps, database and packs equal, the
    probe's BoW scores within 1e-6."""
    snaps, cam, _ = run
    m = snaps[KID]
    jv = jvb.load_vocabulary(jvb.DEFAULT_VOCAB_PATH)
    tv = tvb.load_vocabulary(tvb.DEFAULT_VOCAB_PATH)
    K, W = m["kf_R"].shape[0], jv.n_words
    db0 = np.zeros((K, W), np.float32)
    act0 = np.zeros(K, bool)
    got = tlc.mapper_step_fused(tms.from_numpy(m), torch.from_numpy(db0.copy()),
                                torch.from_numpy(act0.copy()), tv.centroids, tv.idf,
                                KID, torch.from_numpy(cam), k=tv.k, depth=tv.depth,
                                with_probe=False, **KW)
    want = jlc.mapper_step_fused(jmap(m), jnp.asarray(db0), jnp.asarray(act0),
                                 jv.centroids, jv.idf, jnp.int32(KID), jnp.asarray(cam),
                                 k=jv.k, depth=jv.depth, with_probe=False, **KW)
    assert_maps_equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    db1, act1 = np.asarray(want[1]).copy(), np.asarray(want[2]).copy()
    db1[KID], act1[KID] = 0.0, False
    for i in range(KID):                  # the earlier keyframes' vectors
        act1[i] = bool(m["kf_valid"][i])
    db1[~act1] = 0.0
    got = tlc.mapper_step_fused(tms.from_numpy(m), torch.from_numpy(db1.copy()),
                                torch.from_numpy(act1.copy()), tv.centroids, tv.idf,
                                KID, torch.from_numpy(cam), k=tv.k, depth=tv.depth,
                                with_probe=True, prev_cand=2, **KW)
    want = jlc.mapper_step_fused(jmap(m), jnp.asarray(db1), jnp.asarray(act1),
                                 jv.centroids, jv.idf, jnp.int32(KID), jnp.asarray(cam),
                                 k=jv.k, depth=jv.depth, with_probe=True,
                                 prev_cand=jnp.int32(2), **KW)
    assert_maps_equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    pt, pj = got[3].numpy(), np.asarray(want[3])
    np.testing.assert_array_equal(pt[[0, 1, 2, 6, 7, 8, 10, 11, 12]],
                                  pj[[0, 1, 2, 6, 7, 8, 10, 11, 12]])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    assert pj[10] > 0                                      # n_bow of the best candidate


@pytest.mark.parametrize("kid", [4, KID])
def test_map_window_ba(run, kid):
    """Local BA over the covisibility window (3 + 2) of the map after the
    reference's mapping step, 1024 points, 10 iterations: the gathered
    problem equal (edges, selection) and the result within 1e-4."""
    snaps, cam, bf = run
    jm = jlm.mapping_step(jmap(snaps[kid]), jnp.int32(kid), jnp.asarray(cam), **KW)
    ids, fixed = jlm.covis_ba_window(jm, jnp.int32(kid), n_win=3, n_fixed=2)
    m = np_map(jm)
    tm = tms.from_numpy(m)
    ids_t, fixed_t = torch.from_numpy(np.array(ids)), torch.from_numpy(np.array(fixed))
    prob_t = tmb._gather_window_problem(tm, ids_t, fixed_t, bf, 1024)[0]
    prob_j = jmb._gather_window_problem(jm, ids, fixed, bf, 1024)[0]
    for name, a, b in zip(prob_j._fields, prob_t, prob_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=name)
    got = tmb.map_window_ba(tm, ids_t, fixed_t, torch.from_numpy(cam), bf, 0, 1024, 10)
    want = jmb.map_window_ba(jm, ids, fixed, jnp.asarray(cam), bf, 0, 1024, 10)
    assert_maps_equal(got, want, atol=1e-4)
    moved = np.abs(np.asarray(want.mp_pos) - m["mp_pos"]).max()
    assert moved > 1e-4                                   # the BA did move points
