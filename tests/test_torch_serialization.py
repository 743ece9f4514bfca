"""Map and Atlas checkpoints (`orbslam3lib_tpu_torch/models/serialization.py`)
against the JAX reference's `orbslam3lib_tpu/models/serialization.py`: the
same npz keys and dtypes, a file written by either package loading in the
other with every array equal, a field missing from an old file taking the
empty map's value, and the loaded maps on the requested device."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam3lib_tpu.models import atlas as jat
from orbslam3lib_tpu.models import map_state as jms
from orbslam3lib_tpu.models import serialization as jser
from orbslam3lib_tpu_torch.models import atlas as tat
from orbslam3lib_tpu_torch.models import map_state as tms
from orbslam3lib_tpu_torch.models import serialization as tser

from torch_parity import merge_ring_maps


@pytest.fixture(scope="module")
def ring():
    a, b, _, _, _ = merge_ring_maps()
    return a, b


def _files(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _equal(tm, arrays):
    for k in tms.FIELDS:
        x, y = getattr(tm, k).numpy(), np.asarray(arrays[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_map_round_trip(ring, tmp_path, writer):
    a, _ = ring
    path = str(tmp_path / "m.npz")
    if writer == "port":
        tser.save_map(tms.from_numpy(a), path)
    else:
        jser.save_map(jms.MapState(**{k: jnp.asarray(v) for k, v in a.items()}), path)
    _equal(tser.load_map(path), a)
    jm = jser.load_map(path)
    _equal(tms.from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()}), a)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_atlas_round_trip(ring, tmp_path, writer):
    """Two maps, the second current: the same file from either package, and
    each loads in the other."""
    a, b = ring
    ppath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ta = tat.Atlas(32, 1024, 160)
    ta.maps, ta.bad, ta.current = [tms.from_numpy(a), tms.from_numpy(b)], [False] * 2, 1
    ja = jat.Atlas(32, 1024, 160)
    ja.maps = [jms.MapState(**{k: jnp.asarray(v) for k, v in x.items()}) for x in (a, b)]
    ja.bad, ja.current = [False] * 2, 1
    tser.save_atlas(ta, ppath)
    jser.save_atlas(ja, jpath)
    pf, jf = _files(ppath), _files(jpath)
    assert sorted(pf) == sorted(jf)
    for k in pf:
        assert pf[k].dtype == jf[k].dtype, k
        np.testing.assert_array_equal(pf[k], jf[k], err_msg=k)
    path = ppath if writer == "port" else jpath
    t_loaded = tser.load_atlas(path, device="cpu")
    assert (t_loaded.count_maps(), t_loaded.current, t_loaded._dims) == (2, 1, (32, 1024, 160))
    for m, arr in zip(t_loaded.maps, (a, b)):
        _equal(m, arr)
    j_loaded = jser.load_atlas(path)
    assert (j_loaded.count_maps(), j_loaded.current) == (2, 1)
    for m, arr in zip(j_loaded.maps, (a, b)):
        _equal(tms.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()}), arr)


def test_missing_field_takes_the_empty_value(ring, tmp_path):
    """A file without the per-keyframe inertial fields (a map saved before
    they existed) loads with the empty map's values, in both packages."""
    a, _ = ring
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, **{k: v for k, v in a.items() if k not in ("kf_v", "kf_bg")})
    tm = tser.load_map(path)
    jm = jser.load_map(path)
    empty = tms.empty_map(32, 1024, 160)
    for k in ("kf_v", "kf_bg"):
        assert torch.equal(getattr(tm, k), getattr(empty, k))
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)))
    np.testing.assert_array_equal(tm.kf_R.numpy(), a["kf_R"])
    tm.kf_v[0] = 1.0                               # its own tensor, not the template's
    assert not torch.equal(tm.kf_v, getattr(tser.load_map(path), "kf_v"))
