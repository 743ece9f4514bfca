"""Stereo rectification in the port (`utils/rectify.py`) against the JAX
reference (`orbslam3lib_tpu/utils/rectify.py`): Bouguet's rectified
intrinsics, baseline and rotations to 1e-6; the sample maps and the
two-pass maps to 1e-3 px and the shift bounds equal; the per-frame remap
(two 2-tap gathers) against the reference's `remap_bilinear_shifts` on a
rendered distorted pair (160x100) to 1e-3 grey levels (no pixel excepted: both sum
the same two taps per axis, and fusing the second tap's product into the
sum as the reference's compiled graph does leaves a 1-ulp difference on a
few pixels); the exact `remap_bilinear` oracle to 1e-3, and the two-pass
remap against it as tests/test_rectify.py::TestRemapShifts holds the
reference's. The trackers on a raw rig: test_torch_rectify_slam.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.utils import lie as jl, rectify as jr  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import CorridorWorld, StereoRig, orbit_trajectory  # noqa: E402
from orbslam3lib_tpu_torch.utils import cameras as tc, rectify as tr  # noqa: E402
from torch_parity import reference_rectify  # noqa: E402,F401


DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)   # bench.py's
# the remap against the reference's at 160x100: its shift loop compiles
# in seconds there (33 s at 320x200)
TINY_RIG = dict(fx=75.0, fy=75.0, cx=80.0, cy=50.0, width=160, height=100)


def _rot(ax, ay, az):
    R, _ = jl.se3_exp(jnp.asarray([0, 0, 0, ax, ay, az], jnp.float32))
    return np.asarray(R)


# (params_l, params_r, model_l, model_r, R_lr, t_lr, W, H): bench.py's raw
# rig at 320x200; the rotated EuRoC-like rig of tests/test_rectify.py; a
# KB8 rig (the two-pass maps need X increasing along rows: small K)
RIGS = {
    "bench_radtan": (np.array([150, 150, 160, 100, *DIST], np.float32),) * 2
    + (tc.PINHOLE_RADTAN, tc.PINHOLE_RADTAN, np.eye(3), np.array([0.11, 0, 0]), 320, 200),
    "bench_radtan_160": (np.array([75, 75, 80, 50, *DIST], np.float32),) * 2
    + (tc.PINHOLE_RADTAN, tc.PINHOLE_RADTAN, np.eye(3), np.array([0.11, 0, 0]), 160, 100),
    "euroc_rotated": (np.array([229, 228.5, 183.5, 124, -0.28, 0.07, 1e-4, 1.8e-5, 0], np.float32),
                      np.array([227.5, 227, 189.5, 127.5, -0.28, 0.07, -1e-4, 2e-5, 0], np.float32),
                      tc.PINHOLE_RADTAN, tc.PINHOLE_RADTAN, _rot(0.01, -0.02, 0.015),
                      np.array([0.11, 0.002, -0.001]), 320, 200),
    "kb8": (np.array([142.5, 142.5, 160, 100, 0.02, -0.01, 0.003, 0.0], np.float32),) * 2
    + (tc.KANNALA_BRANDT, tc.KANNALA_BRANDT, _rot(0.0, 0.01, 0.0), np.array([0.11, 0, 0]), 320, 200),
}


@pytest.fixture(scope="module")
def rectified():
    return {k: (jr.stereo_rectify(*v), tr.stereo_rectify(*v)) for k, v in RIGS.items()}


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_stereo_rectify_agrees(rectified, rig):
    j, t = rectified[rig]
    np.testing.assert_allclose(t.new_params, j.new_params, rtol=1e-6)
    assert abs(t.baseline - j.baseline) <= 1e-6
    np.testing.assert_allclose(t.R_rect, j.R_rect, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.maps, j.maps, rtol=0, atol=1e-3)


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_twopass_maps_and_bounds_agree(rectified, rig):
    j, t = rectified[rig]
    mj, mt = jr.twopass_maps(j.maps), tr.twopass_maps(t.maps)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-3)
    assert tr.remap_bounds(mt) == jr.remap_bounds(mj)
    assert tr.OOB == jr.OOB


def _distorted_pair(rig_kw):
    rig = StereoRig(**rig_kw)
    world = CorridorWorld(half_w=4.0, half_h=1.5, z0=-4.0, z1=4.0, back_wall=True)
    R, c, _ = orbit_trajectory(5)
    rng = np.random.default_rng(3)
    c_r = c[4] + R[4] @ np.array([rig.baseline, 0, 0], np.float32)
    return np.stack([world.render(R[4], c[4], rig, rng=rng),
                     world.render(R[4], c_r, rig, rng=rng)]).astype(np.uint8).astype(np.float32)


def test_remap_matches_reference_shifts(rectified):
    """The remap on a rendered raw pair, with the maps the tracker builds."""
    j, _ = rectified["bench_radtan_160"]
    mp2 = jr.twopass_maps(j.maps)
    img = _distorted_pair(dict(TINY_RIG, dist=DIST))
    want = np.asarray(jr.remap_bilinear_shifts(jnp.asarray(img), jnp.asarray(mp2),
                                                *jr.remap_bounds(mp2)))
    got = tr.TwoPassRemap(mp2)(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert (want == 0).sum() == (got == 0).sum()       # the same pixels fall outside


def test_exact_remap_agrees_and_bounds_the_two_pass_one(rectified):
    """`remap_bilinear` as the reference's; the two-pass remap against it on
    a smooth image, as tests/test_rectify.py::TestRemapShifts asserts."""
    from scipy.ndimage import gaussian_filter
    j, t = rectified["bench_radtan"]
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (2, 20, 32)).astype(np.float32)
    img = gaussian_filter(np.kron(base, np.ones((10, 10), np.float32)),
                          sigma=(0, 2, 2)).astype(np.float32)
    exact_j = np.asarray(jr.remap_bilinear(jnp.asarray(img), jnp.asarray(j.maps)))
    exact_t = tr.remap_bilinear(torch.from_numpy(img), torch.from_numpy(t.maps)).numpy()
    np.testing.assert_allclose(exact_t, exact_j, rtol=0, atol=1e-3)
    fast = tr.TwoPassRemap(tr.twopass_maps(t.maps))(torch.from_numpy(img)).numpy()
    nz = exact_t > 1e-3
    diff = np.abs(exact_t - fast)[nz]
    assert diff.mean() < 1.0, diff.mean()
    assert np.quantile(diff, 0.99) < 5.0


def test_identity_map_is_exact():
    H, W = 40, 60
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    mp2 = tr.twopass_maps(np.stack([u, v], axis=-1)[None])
    img = np.random.default_rng(1).uniform(0, 255, (1, H, W)).astype(np.float32)
    out = tr.TwoPassRemap(mp2)(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out[:, :H - 1, :W - 1], img[:, :H - 1, :W - 1], atol=1e-3)
