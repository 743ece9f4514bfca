"""The port's data-parallel front end (`parallel/dist_frontend.py`) on
`DeviceMesh(["cpu"] * n)` against the JAX reference's sharded front end on
tests/conftest.py's 8-device virtual mesh, on the case of the reference's
tests/test_dist_frontend.py (8 textured 96x128 stereo frames, 128
keypoints, 4 levels), and against the port's own per-frame
`extract_orb_stereo` + `match_rectified_stereo`.

Tolerances: levels, validity and descriptors equal (integer outputs); xy
within 1e-4 and u_r / depth within 1e-3 against the reference (its own
test's tolerances between its sharded and per-frame runs); against the
port's per-frame run every output equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

torch.set_num_threads(2)

from orbslam3lib_tpu.parallel.dist_frontend import (  # noqa: E402
    make_sharded_frontend as j_make)
from orbslam3lib_tpu_torch.ops.extractor import extract_orb_stereo  # noqa: E402
from orbslam3lib_tpu_torch.parallel.dist_ba import DeviceMesh  # noqa: E402
from orbslam3lib_tpu_torch.parallel.dist_frontend import make_sharded_frontend  # noqa: E402
from orbslam3lib_tpu_torch.tracking.matching import match_rectified_stereo  # noqa: E402

from test_dist_frontend import _texture  # noqa: E402

N, H, W = 8, 96, 128
KW = dict(bf=20.0, min_z=0.3, max_kp=128, n_levels=4)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    imgs = np.stack([_texture(rng, H, W) for _ in range(N)])
    # a threshold of its own per frame: one launch per shard serves them all
    ths = (12.0 + np.arange(N) % 4).astype(np.float32)
    devs = jax.devices()
    assert len(devs) >= 8, "conftest forces 8 virtual CPU devices"
    ref = j_make(Mesh(np.array(devs[:8]), ("dp",)), **KW)(jnp.asarray(imgs), jnp.asarray(ths))
    return imgs, ths, ref


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_frontend_matches_reference(frames, n_shards):
    imgs, ths, (jf, jur, jd) = frames
    out = make_sharded_frontend(DeviceMesh(["cpu"] * n_shards), **KW)(
        torch.from_numpy(imgs), torch.from_numpy(ths))
    assert len(out) == n_shards
    per = N // n_shards
    for s, (f, ur, depth) in enumerate(out):
        assert f.xy.shape == (per, 2, 128, 2) and ur.shape == (per, 128)
        for i in range(per):
            g = s * per + i
            np.testing.assert_array_equal(f.level[i].numpy(), np.asarray(jf.level[g]))
            np.testing.assert_array_equal(f.valid[i].numpy(), np.asarray(jf.valid[g]))
            np.testing.assert_array_equal(f.desc[i].numpy(), np.asarray(jf.desc[g]))
            np.testing.assert_allclose(f.xy[i].numpy(), np.asarray(jf.xy[g]), rtol=0, atol=1e-4)
            np.testing.assert_allclose(ur[i].numpy(), np.asarray(jur[g]), rtol=0, atol=1e-3)
            np.testing.assert_allclose(depth[i].numpy(), np.asarray(jd[g]), rtol=0, atol=1e-3)
    assert int(out[0][0].valid.sum()) > 100


def test_sharded_frontend_matches_per_frame(frames):
    imgs, ths, _ = frames
    out = make_sharded_frontend(DeviceMesh(["cpu"] * 2), **KW)(imgs, ths)
    for g in (0, 3, 5, 7):
        f, ur, depth = out[g // 4]
        i = g % 4
        ref = extract_orb_stereo(torch.from_numpy(imgs[g]), float(ths[g]), max_kp=128,
                                 n_levels=4)
        r_ur, r_d = match_rectified_stereo(ref.xy[0], ref.level[0], ref.desc[0], ref.valid[0],
                                           ref.xy[1], ref.level[1], ref.desc[1], ref.valid[1],
                                           20.0, 0.3, n_levels=4)
        for name in ("xy", "level", "score", "angle", "desc", "valid"):
            assert torch.equal(getattr(f, name)[i], getattr(ref, name)), name
        assert torch.equal(ur[i], r_ur) and torch.equal(depth[i], r_d)


def test_frames_must_split_evenly(frames):
    imgs, ths, _ = frames
    with pytest.raises(ValueError, match="shards"):
        make_sharded_frontend(DeviceMesh(["cpu"] * 3), **KW)(imgs, ths)
