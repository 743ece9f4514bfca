#!/usr/bin/env python3
"""Where the card and the CPU part in the per-frame inertial solve
(`tracking/inertial_opt.pose_inertial_optimization`) of the first frame of
tests/test_torch_cuda.py's inertial problem (`_inertial_inputs`): the
Jacobian of both at one shared state (the CPU's solution and inlier mask),
then the Gauss-Newton iteration replayed step by step on both devices (dx,
inliers, J, J^T J and r at each step, and J's rows that differ most at the
last one).

    python3 tools/inertial_divergence.py          # on a machine with a card
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from orbslam3lib_tpu_torch.tracking import imu as timu, inertial_opt as tio  # noqa: E402
from orbslam3lib_tpu_torch.tracking.pose_opt import PoseObs  # noqa: E402
from orbslam3lib_tpu_torch.utils.robust import (CHI2_MONO, CHI2_STEREO,  # noqa: E402
                                                DELTA_MONO, DELTA_STEREO)


def problem(dev, anchor, frame, cam, state=None):
    """The first frame's residual function on `dev`, around `state` (the
    frame's perturbed start when None): (residuals(dx, inlier), obs)."""
    (cur_np, (g, a, d), obs_np) = frame
    T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    S = lambda s: tio.InertialFrameState(**{k: T(v) for k, v in s.items()})  # noqa: E731
    pre = timu.integrate(timu.empty_preintegrated(device=dev), g, a, d, 2.4e-3, 2.8e-2,
                         1.9e-5, 3e-3)
    obs = PoseObs(**{k: T(v) for k, v in obs_np.items()})
    cur, an = S(state if state is not None else cur_np), S(anchor)
    L9 = tio.sqrt_info(pre.cov, 1e-8)
    Lbg, Lba = tio._bias_whitening(pre)
    delta = torch.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO)
    eye3, z3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    R1, p1 = timu.body_from_cam(an.R, an.t, eye3, z3)

    def residuals(dx, inlier):
        s2 = tio._apply_delta(cur, dx)
        r_vis, chi2, behind = tio._visual(s2.R, s2.t, obs, T(cam), 0, 33.0, inlier, delta)
        R2, p2 = timu.body_from_cam(s2.R, s2.t, eye3, z3)
        r_imu = tio._mtv(L9, timu.inertial_residual(R1, an.v, p1, R2, s2.v, p2, s2.bg, s2.ba,
                                                    pre))
        r = torch.cat([r_vis, r_imu, tio._mtv(Lbg, s2.bg - an.bg),
                       tio._mtv(Lba, s2.ba - an.ba)], -1)
        return r, chi2, behind
    return residuals, obs, pre


def iterations(dev, anchor, frame, cam, n_iters=10):
    """The solve's Gauss-Newton steps (as `inertial_opt._gauss_newton`),
    recording (dx, J^T J, J, inliers, r) at each."""
    residuals, obs, _ = problem(dev, anchor, frame, cam)
    chi2_th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    dx = torch.zeros(15, device=dev)
    inl = torch.ones(obs.valid.shape, device=dev)
    eye = torch.eye(15, device=dev)
    rec = []
    for it in range(n_iters + 1):
        r, J, _ = tio.jacobian_fwd(lambda y: residuals(y, inl), dx)
        H = J.T @ J
        rec.append((dx.cpu().double(), H.cpu().double(), J.cpu().double(),
                    int((inl > 0).sum()), r.cpu().double()))
        if it == n_iters:
            break
        Hd = H + 1e-3 * torch.diag(torch.diagonal(H)) + 1e-6 * eye
        dx = dx - torch.linalg.solve_ex(Hd, J.T @ r)[0]
        _, chi2n, behindn = residuals(dx[None], inl)
        inl = ((chi2n[0] <= chi2_th) & ~behindn[0]).float()
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import test_torch_cuda
    anchor, frames, cam = test_torch_cuda._inertial_inputs()
    frame = frames[0]
    # one shared state: the CPU's solution and inlier mask
    res, obs, pre = problem("cpu", anchor, frame, cam)
    T = lambda x: torch.as_tensor(x)  # noqa: E731
    st, mask, _, _ = tio.pose_inertial_optimization(
        tio.InertialFrameState(**{k: T(v) for k, v in frame[0].items()}),
        tio.InertialFrameState(**{k: T(v) for k, v in anchor.items()}), pre, obs, T(cam),
        bf=33.0)
    state = {k: getattr(st, k).numpy() for k in ("R", "t", "v", "bg", "ba")}
    Js = []
    for dev in ("cpu", "cuda"):
        res, _, _ = problem(dev, anchor, frame, cam, state)
        inl = torch.as_tensor(mask.numpy().astype(np.float32), device=dev)
        _, J, _ = tio.jacobian_fwd(lambda y: res(y, inl), torch.zeros(15, device=dev))
        Js.append(J.cpu().double())
    Hc, Hg = Js[0].T @ Js[0], Js[1].T @ Js[1]
    print(f"at one shared state: J's largest difference {float((Js[1] - Js[0]).abs().max()):.3e}, "
          f"J^T J's over its largest entry {float((Hg - Hc).abs().max() / Hc.abs().max()):.3e}")
    c, g = iterations("cpu", anchor, frame, cam), iterations("cuda", anchor, frame, cam)
    for it, ((dxc, Hc, Jc, nc, rc), (dxg, Hg, Jg, ng, rg)) in enumerate(zip(c, g)):
        print(f"step {it}: inliers {nc} / {ng}, dx {float((dxg - dxc).abs().max()):.3e}, "
              f"J^T J {float((Hg - Hc).abs().max() / Hc.abs().max()):.3e} of its largest, "
              f"J {float((Jg - Jc).abs().max()):.3e}, r {float((rg - rc).abs().max()):.3e}")
    Jc, Jg = c[-1][2], g[-1][2]
    d = (Jg - Jc).abs().max(dim=1).values
    M = Jc.shape[0]
    for i in torch.argsort(d, descending=True)[:5].tolist():
        kind = "visual" if i < M - 15 else ("inertial" if i < M - 6 else "bias")
        print(f"row {i} of {M} ({kind}): {float(d[i]):.3e}; CPU {Jc[i, :6].numpy().round(2)}, "
              f"card {Jg[i, :6].numpy().round(2)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
