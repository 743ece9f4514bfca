"""The VI window's analytic normal equations (`vi_ba._normal_equations_torch`,
the plain version of the `vi_eval` / `vi_step` kernels) against the
forward-mode Jacobian the torch path solves with (`jacobian_fwd` over
`vi_ba._residuals`): J^T J + 1e-5 I and J^T r at a seeded, non-zero x, in
float64; and which path a window takes. Imports no JAX.

Windows (`torch_parity.vi_problem`): stereo and mono rows, Huber-weighted
outliers, landmarks behind a camera, a rotated and offset T_bc, a fixed
anchor and a fixed keyframe inside the window, padding slots, a gap without
IMU data, per-keyframe biases away from the preintegrations' linearisation
point; x puts one keyframe past the Lie series' range (theta^2 > 0.09).

Tolerance: each entry of H within 1e-12 of sqrt(H_ii H_jj) and each entry
of g within 1e-12 of sqrt(H_ii) |r|, the scales a Gram matrix and its
right-hand side give (Cauchy-Schwarz). The two differ by float64 rounding
(1.2e-15 to 6.8e-15 on these windows) and by the truncation of the Lie
series, which the forward-mode path differentiates as polynomials (below
1e-17 at this x's small angles; ~2e-11 at theta^2 = 0.09). The windows'
rotations are projected onto SO(3) in float64 (`vi_problem`).
"""
import numpy as np
import pytest
import torch

from orbslam3lib_tpu_torch.mapping import vi_ba
from orbslam3lib_tpu_torch.ops import cuda_vi
from orbslam3lib_tpu_torch.tracking.inertial_opt import jacobian_fwd
from orbslam3lib_tpu_torch.utils import cameras

from torch_parity import vi_problem

CASES = {
    "stereo": dict(),
    "mono": dict(bf=0.0),
    "padded": dict(pad=2),
    "gap_without_imu": dict(no_imu=(2,), fixed=(0, 3)),
    "euroc_width": dict(C=9, F=96, seed=5),
}


def _x(w, seed: int):
    """A seeded x of the window's shape: poses ~0.02 (one keyframe's
    rotation at 0.45 rad), velocities ~0.05, biases ~1e-3."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(w.C, 15)) * np.array([0.02] * 6 + [0.05] * 3 + [1e-3] * 6)
    x[1, 3:6] = [0.3, -0.2, 0.25]
    return torch.from_numpy(x.reshape(-1)).to(w.R0.dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_analytic_normal_equations_match_forward_mode(case):
    m, kw = vi_problem(dtype=torch.float64, **CASES[case])
    w = vi_ba.window_problem(m, **kw)
    assert w.n_par == 15 * w.C and w.R0.dtype == torch.float64
    x = _x(w, 3)
    r, J, _ = jacobian_fwd(lambda y: vi_ba._residuals(w, y), x)
    H_ad = J.T @ J + 1e-5 * torch.eye(w.n_par, dtype=x.dtype)
    g_ad = J.T @ r
    H, g = vi_ba._normal_equations_torch(w, x)
    d = torch.sqrt(torch.diagonal(H_ad))
    assert float(((H - H_ad).abs() / (d[:, None] * d[None, :])).max()) <= 1e-12
    assert float(((g - g_ad).abs() / (d * torch.linalg.norm(r))).max()) <= 1e-12
    # the problem reaches what it is meant to: Huber-weighted and dropped
    # rows, stereo rows when bf > 0, and inertial rows
    _, wt, _, _ = vi_ba._visual(w, *(y for y in vi_ba._unpack(w, x[None])[:2]))
    assert bool(((wt > 0) & (wt < w.w_sig)).any()) and bool(((wt == 0) & (w.obs_f > 0)).any())
    assert bool(w.is_stereo.any()) == (kw["bf"] > 0)
    assert float(w.gap_ok.sum()) == w.C - 1 - len(CASES[case].get("no_imu", ())) \
        - CASES[case].get("pad", 0)


@pytest.mark.parametrize("device,model,per_kf_bias,fused", [
    ("cuda", cameras.PINHOLE, True, True), ("cpu", cameras.PINHOLE, True, False),
    ("cuda", cameras.PINHOLE_RADTAN, True, False), ("cuda", cameras.KANNALA_BRANDT, True, False),
    ("cuda", cameras.PINHOLE, False, False)])
def test_kernels_taken_on_cuda_pinhole_per_keyframe_bias_only(device, model, per_kf_bias,
                                                              fused):
    assert vi_ba._fused(torch.device(device), model, per_kf_bias) is fused


def test_cpu_window_takes_the_torch_path():
    """On the CPU the window runs the forward-mode path, one evaluation an
    iteration, and the kernels' wrapper refuses its tensors."""
    m, kw = vi_problem()
    before = vi_ba.evals_torch, cuda_vi.eval_launches, cuda_vi.step_launches
    res = vi_ba.local_inertial_ba(m, n_iters=3, **kw)
    assert (vi_ba.evals_torch - before[0], cuda_vi.eval_launches - before[1],
            cuda_vi.step_launches - before[2]) == (3, 0, 0)
    assert res.kf_R.shape == (6, 3, 3) and res.bg.shape == (6, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_vi.pack(vi_ba.window_problem(m, **kw))
