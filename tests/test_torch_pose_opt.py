"""The motion-only pose solve's dispatch (`tracking/pose_opt.py`) and its
kernels' registration, on the CPU: a solve evaluates its residuals through
the module attribute `_residuals_jacobians` `n_rounds * (iters_per_round +
1)` times on every path (what a wrapper set on the module sees), CPU tensors
take the torch ops and count in `evals_torch`, and the kernel library names
`csrc/pose_opt.cu` and its two C entry points with the argument lists their
sources declare. The kernels themselves run only on a card
(tests/test_torch_cuda.py). Imports no JAX."""
import re

import numpy as np
import pytest
import torch

from orbslam3lib_tpu_torch.ops import _cuda_lib, cuda_pose
from orbslam3lib_tpu_torch.tracking import pose_opt
from orbslam3lib_tpu_torch.utils import cameras

from torch_parity import POSE_BF, POSE_CAM, pose_problem

SCHEDULES = [(2, 2), (4, 10)]          # the orbit's and EuRoC's rounds x iterations


def _solve(n_rounds, iters, n=256, seed=0):
    obs, _, (R0, t0) = pose_problem(n, seed)
    return pose_opt.pose_optimization(
        torch.from_numpy(R0), torch.from_numpy(t0),
        pose_opt.PoseObs(**{k: torch.from_numpy(v) for k, v in obs.items()}),
        torch.from_numpy(POSE_CAM), bf=POSE_BF, n_rounds=n_rounds, iters_per_round=iters)


@pytest.mark.parametrize("n_rounds,iters", SCHEDULES)
def test_solve_calls_the_module_attribute_once_per_evaluation(monkeypatch, n_rounds, iters):
    calls = []
    inner = pose_opt._residuals_jacobians

    def counted(*a, **k):
        out = inner(*a, **k)
        calls.append(out[2])
        return out

    monkeypatch.setattr(pose_opt, "_residuals_jacobians", counted)
    _, _, inlier, _ = _solve(n_rounds, iters)
    assert len(calls) == n_rounds * (iters + 1)
    # every round ends with the evaluation that classifies: the last one's
    # chi2 sets the returned inliers
    obs, _, _ = pose_problem(256, 0)
    th = np.where(obs["is_stereo"], 7.815, 5.991)
    assert not np.any(inlier.numpy() & (calls[-1].numpy() > th))


@pytest.mark.parametrize("n_rounds,iters", SCHEDULES)
def test_cpu_tensors_take_the_torch_path(n_rounds, iters):
    torch_ops = pose_opt.evals_torch
    launches = cuda_pose.eval_launches, cuda_pose.step_launches
    R, t, _, n_inl = _solve(n_rounds, iters)
    assert pose_opt.evals_torch - torch_ops == n_rounds * (iters + 1)
    assert (cuda_pose.eval_launches, cuda_pose.step_launches) == launches
    assert R.device.type == "cpu" and int(n_inl) > 150


def test_only_cuda_pinhole_solves_take_the_kernels():
    cpu = torch.eye(3)
    for model in (cameras.PINHOLE, cameras.PINHOLE_RADTAN, cameras.KANNALA_BRANDT):
        assert not pose_opt._fused(cpu, model)
    meta = torch.empty((3, 3), device="meta")
    assert not pose_opt._fused(meta, cameras.PINHOLE)


def test_wrappers_refuse_cpu_tensors():
    obs, _, (R0, t0) = pose_problem(64)
    o = pose_opt.PoseObs(**{k: torch.from_numpy(v) for k, v in obs.items()})
    R0, t0 = torch.from_numpy(R0), torch.from_numpy(t0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pose.pose_eval(R0, t0, o, torch.from_numpy(POSE_CAM), POSE_BF)
    r, J, chi2, behind = pose_opt._residuals_jacobians(R0, t0, o, cameras.PINHOLE,
                                                       torch.from_numpy(POSE_CAM), POSE_BF)
    ones = torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pose.pose_step(R0, t0, r, J, chi2, behind, o.inv_sigma2, ones, ones, ones, 1e-3)


def test_library_builds_the_pose_source():
    assert "pose_opt.cu" in _cuda_lib.SOURCES
    assert (_cuda_lib.CSRC / "pose_opt.cu").is_file()
    assert {"pose_eval_launch", "pose_step_launch"} <= set(_cuda_lib.SIGNATURES)


def _declared_params(name: str):
    """The C parameter types of the entry point `name`, from its source."""
    for src in _cuda_lib.SOURCES:
        text = (_cuda_lib.CSRC / src).read_text()
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        if m:
            return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    raise AssertionError(f"{name} is declared in no source")


@pytest.mark.parametrize("name", sorted(_cuda_lib.SIGNATURES))
def test_signatures_match_the_sources(name):
    """Each argtype of SIGNATURES is the C parameter's: a pointer as
    c_void_p, an int as c_int, a float as c_float (ctypes would otherwise
    pass a float as an int, or cut a pointer to 32 bits)."""
    want = {"c_void_p": "*", "c_int": "int", "c_float": "float"}
    params = _declared_params(name)
    argtypes = _cuda_lib.SIGNATURES[name]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        kind = want[argtype.__name__]
        assert param.endswith("*") if kind == "*" else param.split()[-1] == kind, (param, argtype)
