"""The motion-only pose solve's two kernels (`csrc/pose_opt.cu`): one launch
per evaluation of the residuals and Jacobians, one per Gauss-Newton step.

`pose_eval` has the contract of `tracking.pose_opt._residuals_jacobians`
for `cameras.PINHOLE`, `pose_step` that of one iteration's step of
`tracking.pose_opt.pose_optimization`; their plain versions are that
module's torch path, which `pose_opt` takes on the CPU and for the other
camera models. They take float32 CUDA tensors and raise on anything else.
A call allocates its outputs and launches once on the current stream: no
sync, no scratch, nothing read back.
"""
from __future__ import annotations

import torch

from . import _cuda_lib

eval_launches = 0   # kernel launches made by this process
step_launches = 0

_fns = None         # (pose_eval_launch, pose_step_launch), resolved once
_F32, _BOOL = torch.float32, torch.bool


def reset_count() -> None:
    global eval_launches, step_launches
    eval_launches = step_launches = 0


def _entry_points():
    global _fns
    if _fns is None:
        lib = _cuda_lib.library()
        _fns = (lib.pose_eval_launch, lib.pose_step_launch)
    return _fns


def _check(R, t, rows) -> int:
    """R (3, 3) and t (3,) float32 and `rows`, (tensor, shape, dtype)
    triples, all on one CUDA device, whose index it returns."""
    if not R.is_cuda:
        raise ValueError(f"the pose kernels run on CUDA tensors, got {R.device}")
    idx = R.get_device()
    for x, shape, dtype in ((R, (3, 3), _F32), (t, (3,), _F32)) + rows:
        if x.shape != shape or x.dtype is not dtype or x.get_device() != idx:
            raise ValueError(f"expected {shape} {dtype} on cuda:{idx}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return idx


def _launch(fn, name: str, idx: int, ins, args) -> None:
    """Launch `fn` on device idx's current stream with the pointers of `ins`
    (made contiguous, held until the launch is queued), then `args`."""
    ins = [x.contiguous() for x in ins]
    call = (*[x.data_ptr() for x in ins], *args, torch._C._cuda_getCurrentRawStream(idx))
    if torch.cuda.current_device() == idx:
        err = fn(*call)
    else:
        with torch.cuda.device(idx):
            err = fn(*call)
    _cuda_lib.check(err, name)


def pose_eval(R, t, obs, cam_params, bf: float):
    """(r (N, 3), J (N, 3, 6), chi2 (N,), behind (N,) bool) of the pinhole
    observations `obs` (a `PoseObs`; `cam_params` [fx, fy, cx, cy]) at the
    pose (R, t)."""
    global eval_launches
    n = obs.p_world.shape[0]
    idx = _check(R, t, ((obs.p_world, (n, 3), _F32), (obs.uv, (n, 2), _F32),
                        (obs.inv_sigma2, (n,), _F32), (obs.u_right, (n,), _F32),
                        (obs.is_stereo, (n,), _BOOL)))
    if (cam_params.get_device() != idx or cam_params.dtype is not _F32
            or cam_params.numel() < 4):
        raise ValueError(f"cam_params: expected [fx, fy, cx, cy] float32 on cuda:{idx}, "
                         f"got {tuple(cam_params.shape)} {cam_params.dtype} on "
                         f"{cam_params.device}")
    dev = R.device
    r = torch.empty((n, 3), dtype=_F32, device=dev)
    J = torch.empty((n, 3, 6), dtype=_F32, device=dev)
    chi2 = torch.empty((n,), dtype=_F32, device=dev)
    behind = torch.empty((n,), dtype=_BOOL, device=dev)
    _launch(_entry_points()[0], "pose_eval_launch", idx,
            (R, t, obs.p_world, obs.uv, obs.inv_sigma2, obs.u_right, obs.is_stereo,
             cam_params),
            (float(bf), n, r.data_ptr(), J.data_ptr(), chi2.data_ptr(), behind.data_ptr()))
    eval_launches += 1
    return r, J, chi2, behind


def pose_step(R, t, r, J, chi2, behind, inv_sigma2, delta, inlier, valid,
              lm_lambda: float):
    """One damped Gauss-Newton step from (R, t): the new (R, t), from one
    evaluation's (r, J, chi2, behind), the rows' inv_sigma2, Huber `delta`,
    `inlier` and `valid` (float 0/1) and the damping `lm_lambda`."""
    global step_launches
    n = r.shape[0]
    idx = _check(R, t, ((r, (n, 3), _F32), (J, (n, 3, 6), _F32), (chi2, (n,), _F32),
                        (behind, (n,), _BOOL), (inv_sigma2, (n,), _F32), (delta, (n,), _F32),
                        (inlier, (n,), _F32), (valid, (n,), _F32)))
    dev = R.device
    R_out = torch.empty((3, 3), dtype=_F32, device=dev)
    t_out = torch.empty((3,), dtype=_F32, device=dev)
    _launch(_entry_points()[1], "pose_step_launch", idx,
            (R, t, r, J, chi2, behind, inv_sigma2, delta, inlier, valid),
            (float(lm_lambda), n, R_out.data_ptr(), t_out.data_ptr()))
    step_launches += 1
    return R_out, t_out
