"""The port's Atlas (`orbslam3lib_tpu_torch/models/atlas.py`) against the
JAX reference's (`orbslam3lib_tpu/models/atlas.py`) on tests/test_atlas.py's
small maps (16 KF / 256 MP slots, 64 features), built with numpy and the
port's map model and handed to both packages as the same arrays.

Tolerances: integer and bool fields equal; f32 fields within 1e-6 absolute
(positions of a few metres through one 3x3 product: a few ulp).

Also the three faults of the reference that the port does not carry over,
each shown on the reference: `Atlas.remove_bad_maps` raises with three maps
or more (so a merge with two archives raises), `merge_into` writes every
landmark past the destination's last slot into that one slot, and
`merge_into` keeps the landmarks of the keyframes it drops past the last
keyframe slot, naming keyframe ids past the map."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from orbslam3lib_tpu.models import atlas as jat  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms  # noqa: E402
from orbslam3lib_tpu.utils import lie as jlie  # noqa: E402
from orbslam3lib_tpu_torch.models import atlas as tat  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402

F = 64
F32_TOL = 1e-6


def small_map_arrays(n_kf=3, n_mp=40, seed=0, max_kf=16, max_mp=256):
    """tests/test_atlas.py's `small_map` as numpy map arrays: n_kf keyframes
    10 cm apart, each binding its first n_mp features to landmarks 0..n_mp-1,
    whose positions are uniform in a 6 m cube; plus a spanning tree and
    per-keyframe velocities, so that every remapped field is exercised."""
    rng = np.random.default_rng(seed)
    m = tms.empty_map(max_kf=max_kf, max_mp=max_mp, n_feat=F)
    for i in range(n_kf):
        xy = rng.uniform(0, 600, (F, 2)).astype(np.float32)
        desc = rng.integers(0, 2, (F, 256)).astype(np.int8)
        assoc = np.full(F, -1, np.int32)
        assoc[:min(n_mp, F)] = np.arange(min(n_mp, F))
        tms.insert_keyframe(
            m, torch.eye(3), torch.tensor([0.1 * i, 0, 0], dtype=torch.float32),
            float(i), torch.from_numpy(xy), torch.zeros(F, dtype=torch.int32),
            torch.from_numpy(desc), torch.ones(F, dtype=torch.bool),
            torch.from_numpy(assoc), torch.zeros(F))
    arr = tms.to_numpy(m)
    arr["mp_pos"] = rng.uniform(-3, 3, (max_mp, 3)).astype(np.float32)
    arr["mp_valid"] = np.zeros(max_mp, bool)
    arr["mp_valid"][:n_mp] = True
    arr["mp_first_kf"] = np.full(max_mp, -1, np.int32)
    arr["mp_first_kf"][:n_mp] = rng.integers(0, n_kf, n_mp)
    arr["mp_normal"] = rng.normal(size=(max_mp, 3)).astype(np.float32)
    arr["mp_found"] = rng.uniform(1, 5, max_mp).astype(np.float32)
    arr["n_mp"] = np.int32(n_mp)
    arr["kf_v"] = rng.normal(size=(max_kf, 3)).astype(np.float32)
    arr["kf_parent"] = np.where(np.arange(max_kf) < n_kf, np.arange(max_kf) - 1,
                                -1).astype(np.int32)
    return arr


def to_jax(arr):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in arr.items()})


def to_torch(arr):
    return tms.from_numpy(arr)


def assert_maps_equal(tm, jm, f32_tol=F32_TOL):
    for k in tms.FIELDS:
        a, b = getattr(tm, k).numpy(), np.asarray(getattr(jm, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=0, atol=f32_tol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def sim3(seed=3, log_s=np.log(1.2)):
    rng = np.random.default_rng(seed)
    xi = np.zeros(7, np.float32)
    xi[:6] = (rng.normal(size=6) * 0.3).astype(np.float32)
    xi[6] = log_s
    R, t, s = (np.array(x) for x in jlie.sim3_exp(jnp.asarray(xi)))
    return R, t, np.float32(s)


def test_transform_map_matches_reference():
    arr = small_map_arrays()
    arr["mp_valid"][5] = False                       # an invalid landmark stays
    R, t, s = sim3()
    jm = jat.transform_map(to_jax(arr), jnp.asarray(R), jnp.asarray(t), jnp.float32(s))
    tm = tat.transform_map(to_torch(arr), torch.from_numpy(R), torch.from_numpy(t),
                           torch.tensor(s))
    assert_maps_equal(tm, jm)
    np.testing.assert_array_equal(tm.mp_pos[5].numpy(), arr["mp_pos"][5])


@pytest.mark.parametrize("free_gap", [False, True])
def test_merge_into_matches_reference(free_gap):
    """Three keyframes + 40 landmarks take in two + 30 (tests/test_atlas.py),
    and with `free_gap` the destination has freed slots among its landmarks
    and a culled source keyframe, so the free-slot order and the keyframe
    compaction both matter."""
    dst = small_map_arrays(3, 40, seed=0)
    src = small_map_arrays(3 if free_gap else 2, 30, seed=1)
    if free_gap:
        dst["mp_valid"][[3, 17, 18]] = False
        dst["n_mp"] = np.int32(dst["mp_valid"].sum())
        src["kf_valid"][1] = False
    jm = jat.merge_into(to_jax(dst), to_jax(src))
    tm = tat.merge_into(to_torch(dst), to_torch(src))
    assert_maps_equal(tm, jm, f32_tol=0.0)           # copies: exact
    assert int(tm.n_kf) == 5
    assert int(tm.n_mp) == (67 if free_gap else 70)


def test_atlas_api():
    at = tat.Atlas(max_kf=16, max_mp=256, n_feat=F)
    at.current_map = to_torch(small_map_arrays(seed=0))
    assert at.create_new_map() == 1 and at.count_maps() == 2
    assert int(at.current_map.n_kf) == 0
    at.current_map = to_torch(small_map_arrays(n_kf=2, n_mp=20, seed=2))
    with pytest.raises(ValueError):
        at.set_map_bad(at.current)
    at.merge(0, torch.eye(3), torch.zeros(3), torch.tensor(1.0))
    assert at.count_maps() == 1 and at.current == 0 and at.bad == [False]
    assert int(at.current_map.n_kf) == 5


def test_atlas_merge_matches_reference():
    """`Atlas.merge` (transform + merge_into + removal) on two maps."""
    a, b = small_map_arrays(seed=0), small_map_arrays(n_kf=2, n_mp=20, seed=2)
    R, t, s = sim3(seed=5, log_s=np.log(0.8))
    ja = jat.Atlas(16, 256, F)
    ja.maps, ja.bad, ja.current = [to_jax(a), to_jax(b)], [False, False], 1
    ja.merge(0, jnp.asarray(R), jnp.asarray(t), jnp.float32(s))
    ta = tat.Atlas(16, 256, F)
    ta.maps, ta.bad, ta.current = [to_torch(a), to_torch(b)], [False, False], 1
    ta.merge(0, torch.from_numpy(R), torch.from_numpy(t), torch.tensor(s))
    assert ta.count_maps() == ja.count_maps() == 1 and ta.current == ja.current == 0
    assert_maps_equal(ta.current_map, ja.current_map)


def test_three_map_merge_reference_fault():
    """Named exception, a fault of the reference (ROADMAP queue 3): with
    three maps, merging map 1 into the current map 2 raises in its
    `remove_bad_maps` (`list.index` compares maps of arrays). The port
    merges, and map 2 stays current at its new index 1."""
    arrs = [small_map_arrays(seed=i, n_kf=2, n_mp=10 + i) for i in range(3)]
    ja = jat.Atlas(16, 256, F)
    ja.maps, ja.bad, ja.current = [to_jax(a) for a in arrs], [False] * 3, 2
    with pytest.raises(ValueError, match="ambiguous"):
        ja.merge(1, jnp.eye(3), jnp.zeros(3), jnp.float32(1.0))
    ta = tat.Atlas(16, 256, F)
    ta.maps, ta.bad, ta.current = [to_torch(a) for a in arrs], [False] * 3, 2
    first, current = ta.maps[0], ta.maps[2]
    ta.merge(1, torch.eye(3), torch.zeros(3), torch.tensor(1.0))
    assert ta.count_maps() == 2 and ta.current == 1
    assert ta.maps[0] is first and ta.current_map is current
    assert int(ta.current_map.n_kf) == 4 and int(ta.current_map.n_mp) == 12 + 11


def test_overflow_scatter_reference_fault():
    """Named exception, a fault of the reference (ROADMAP queue 3): a source
    with more landmarks than the destination has slots. The reference clips
    each landmark's rank to the last free slot, so all 36 landmarks past
    the end land on slot 63 and the source keyframes' observations of them
    all point there. The port drops them: the first 64 fill the slots in
    order, every other observation becomes -1."""
    dst = small_map_arrays(n_kf=1, n_mp=0, seed=0, max_kf=16, max_mp=64)
    src = small_map_arrays(n_kf=2, n_mp=100, seed=1, max_kf=16, max_mp=256)
    src["kf_mp"][1] = np.arange(36, 100)             # src keyframe 1 sees 36..99
    jm = jat.merge_into(to_jax(dst), to_jax(src))
    tm = tat.merge_into(to_torch(dst), to_torch(src))
    j_row = np.asarray(jm.kf_mp[2])                   # src keyframe 1 lands at slot 2
    np.testing.assert_array_equal(j_row[:27], np.arange(36, 63))
    assert (j_row[27:] == 63).all()                   # the fault: 37 ids on slot 63
    t_row = tm.kf_mp[2].numpy()
    np.testing.assert_array_equal(t_row[:28], np.arange(36, 64))
    assert (t_row[28:] == -1).all()
    np.testing.assert_array_equal(tm.mp_pos[:64].numpy(), src["mp_pos"][:64])
    assert int(tm.n_mp) == 64 and tm.mp_valid.all()
    # the rest of the merge agrees with the reference's
    for k in ("kf_R", "kf_t", "kf_valid", "kf_desc", "kf_parent", "n_kf"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)))


def test_keyframe_overflow_reference_fault():
    """Named exception, a fault of the reference (ROADMAP queue 3): the
    destination has 14 of 16 keyframe slots in use and the source 4
    keyframes, so the source's keyframes 2 and 3 are dropped. The reference
    keeps the landmarks they created, with `mp_first_kf` 16 and 17, past
    the map. The port drops those landmarks: the others fill the free slots
    in order, and the kept keyframes' observations of the dropped ones
    become -1. The keyframes agree with the reference's."""
    dst = small_map_arrays(n_kf=14, n_mp=40, seed=0, max_kf=16)
    src = small_map_arrays(n_kf=4, n_mp=30, seed=1, max_kf=16)
    first = src["mp_first_kf"][:30]
    keep = first < 2
    assert 0 < keep.sum() < 30
    jm = jat.merge_into(to_jax(dst), to_jax(src))
    tm = tat.merge_into(to_torch(dst), to_torch(src))
    j_first = np.asarray(jm.mp_first_kf)[np.asarray(jm.mp_valid)]
    assert (j_first >= 16).sum() == (~keep).sum()     # the fault
    n_keep = int(keep.sum())
    assert int(tm.n_kf) == 16 and int(tm.n_mp) == 40 + n_keep
    assert not tm.mp_valid[40 + n_keep:].any()
    np.testing.assert_array_equal(tm.mp_first_kf[40:40 + n_keep].numpy(), 14 + first[keep])
    np.testing.assert_array_equal(tm.mp_pos[40:40 + n_keep].numpy(),
                                  src["mp_pos"][:30][keep])
    assert int(tm.mp_first_kf[tm.mp_valid].max()) < 16
    remap = np.full(30, -1)
    remap[keep] = 40 + np.arange(n_keep)
    for k in (14, 15):                                # src keyframes 0 and 1
        np.testing.assert_array_equal(tm.kf_mp[k, :30].numpy(), remap)
    np.testing.assert_array_equal(tm.kf_parent.numpy(), np.asarray(jm.kf_parent))
    for k in ("kf_R", "kf_t", "kf_valid", "kf_desc", "n_kf"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)))
