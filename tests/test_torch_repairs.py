"""Two faults of the reference that the port repairs, each shown on the
reference, repaired in the port, and put back in the port by its named
exception in tests/torch_parity.py (ROADMAP queue 3, "Repaired in the
port").

1. The Lie maps' small-angle series (`utils/lie.py`): the reference takes
   them only below theta^2 = 1e-8, so its f32 forward-mode Jacobians are
   rounding noise for theta in ~[1e-4, 1e-1] (se3_exp's 0.25 off f64 at
   1e-4 on these tangents). The port takes the series below theta^2 = 0.09
   and `_sim3_W`'s coefficients in f64. Held: the port's f32 Jacobians of
   se3_exp, so3_exp and sim3_exp within 2e-7 of f64 at 1e-5, 2.5e-4, 3e-3
   and 1e-2 rad (tools/lie_small_angle.py reads at most 8.3e-8 there, f32
   rounding of entries of order 1); `reference_small_angle()` puts the
   reference's noise back.
2. The rectification edge (`utils/rectify.py`): a sample exactly on the
   last row or column (coord = n - 1) takes its fraction from the
   unclipped floor in the reference and reads row n - 2 at full weight;
   the port reads row n - 1. `reference_rectify_edge()` puts the
   reference's back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3lib_tpu.utils import lie as jlie, rectify as jrect
from orbslam3lib_tpu_torch.utils import lie as tlie, rectify as trect

from torch_parity import reference_rectify_edge, reference_small_angle

THETAS = (1e-5, 2.5e-4, 3e-3, 1e-2)
MAPS = {
    "se3_exp": lambda v: torch.cat([tlie.se3_exp(v)[0].flatten(-2), tlie.se3_exp(v)[1]], -1),
    "so3_exp": lambda v: tlie.so3_exp(v[..., 3:]).flatten(-2),
    "sim3_exp": lambda v: tlie.sim3_exp(torch.cat([v, torch.full_like(v[..., :1], 0.01)], -1))[1],
}


def _tangents(theta, n=32, seed=0):
    rng = np.random.default_rng(seed)
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    rho = rng.normal(size=(n, 3))
    rho *= 0.5 / np.linalg.norm(rho, axis=1, keepdims=True)
    return np.concatenate([rho, theta * ax], axis=1)


def _jac(f, x, dtype):
    return tlie.value_and_rowwise_jacobian(f, torch.as_tensor(x, dtype=dtype))[1].double()


@pytest.mark.parametrize("name", sorted(MAPS))
@pytest.mark.parametrize("theta", THETAS)
def test_f32_lie_jacobians_agree_with_f64(theta, name):
    x = _tangents(theta)
    err = (_jac(MAPS[name], x, torch.float32) - _jac(MAPS[name], x, torch.float64)).abs().max()
    assert err < 2e-7, float(err)


def test_reference_small_angle_puts_the_noise_back():
    """Under `reference_small_angle()` the port's f32 Jacobian of se3_exp at
    2.5e-4 rad is the reference's `jax.jacfwd` (to 1e-6), and both are off
    f64 by more than 1e-3."""
    x = np.array([0.02, -0.02, 0.003, 2.5e-4, 0.75e-4, -1.25e-4])

    def flat(v):
        R, t = jlie.se3_exp(v)
        return jnp.concatenate([R.reshape(-1), t])
    J_ref = np.asarray(jax.jacfwd(flat)(jnp.asarray(x, jnp.float32)), np.float64)
    J64 = _jac(MAPS["se3_exp"], x[None], torch.float64)[0].numpy()
    with reference_small_angle():
        J_put_back = _jac(MAPS["se3_exp"], x[None], torch.float32)[0].numpy()
    J_port = _jac(MAPS["se3_exp"], x[None], torch.float32)[0].numpy()
    np.testing.assert_allclose(J_put_back, J_ref, rtol=0, atol=1e-6)
    assert np.abs(J_ref - J64).max() > 1e-3
    assert np.abs(J_port - J64).max() < 2e-7


def _edge_case():
    """A 6 x 5 image whose rows differ, and a map sampling row y = H - 1
    (the last) at every column x = 2, and the last column x = W - 1 at row 3."""
    H, W = 6, 5
    img = (10.0 * np.arange(H)[:, None] + np.arange(W)[None, :]).astype(np.float32)
    mp = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).astype(np.float32)
    mp[..., 0] = 2.0
    mp[..., 1] = H - 1.0
    mp[3, :, 0], mp[3, :, 1] = W - 1.0, 3.0
    return img, mp


def test_rectify_edge_sample_reads_the_last_row():
    img, mp = _edge_case()
    H, W = img.shape
    ref = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(mp)))
    port = trect.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mp)).numpy()
    # the reference reads row H - 2 (and column W - 2) at full weight
    assert ref[0, 0] == img[H - 2, 2] and ref[3, 0] == img[3, W - 2]
    # the port reads the sample's own pixel
    assert port[0, 0] == img[H - 1, 2] and port[3, 0] == img[3, W - 1]
    # the per-frame two-pass remap on the card's path reads it too
    two = trect.TwoPassRemap(np.stack([mp, mp]))(torch.from_numpy(np.stack([img, img])))
    assert two[0, 0, 0] == img[H - 1, 2] and two[1, 3, 0] == img[3, W - 1]
    with reference_rectify_edge():
        back = trect.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mp)).numpy()
        two_back = trect.TwoPassRemap(np.stack([mp, mp]))(torch.from_numpy(np.stack([img, img])))
    np.testing.assert_array_equal(back, ref)
    assert two_back[0, 0, 0] == img[H - 2, 2] and two_back[0, 3, 0] == img[3, W - 2]
