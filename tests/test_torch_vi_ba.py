"""The port's windowed visual-inertial BA (`orbslam3lib_tpu_torch/mapping/
vi_ba.py`) against the JAX reference's on the window of tests/test_vi_ba.py
(C keyframes on the corridor, perturbed poses, exact landmarks), on the CPU:
with a shared and a per-keyframe bias, with stored velocities seeding some
keyframes, and in a padded window that holds keyframe 0 (where the
reference's scatter leaves slot 0 as it was), every keyframe's velocity
stored there.

Tolerances: poses 1e-4 (rotation entries, metres), velocities 1e-3 m/s,
biases 1e-4; the fixed anchor bit-equal before and after.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3lib_tpu.mapping import vi_ba as jvb
from orbslam3lib_tpu.tracking import imu as jimu
from orbslam3lib_tpu_torch.mapping import vi_ba as tvb
from orbslam3lib_tpu_torch.models import map_state as tms
from orbslam3lib_tpu_torch.tracking import imu as timu
from tests.test_vi_ba import C, CAM, build_window
from torch_parity import reference_lie  # noqa: E402,F401


def torch_map(m):
    return tms.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})


@pytest.mark.parametrize("per_kf_bias,padded", [(False, False), (True, False), (True, True)])
def test_local_inertial_ba(per_kf_bias, padded):
    m, pres, _, _, true_v = build_window()
    n_slots = C + 3 if padded else C
    ids = np.full(n_slots, -1, np.int32)
    ids[:C] = np.arange(C)
    fixed = np.zeros(n_slots, bool)
    fixed[0] = True
    pre_valid = np.zeros(n_slots - 1, bool)
    pre_valid[:C - 1] = True
    pj = {k: np.asarray(v) for k, v in pres._asdict().items()}
    if padded:     # empty preintegrations for the padded gaps
        e = {k: np.asarray(v) for k, v in jimu.empty_preintegrated()._asdict().items()}
        pj = {k: np.concatenate([pj[k], np.stack([e[k]] * 3)]) for k in pj}
    pres_j = jimu.Preintegrated(**{k: jnp.asarray(v) for k, v in pj.items()})
    pres_t = timu.Preintegrated.from_arrays(pres_j)
    # stored velocities on keyframes 1 and 3 (near the truth), the rest in
    # closed form; in the padded window on every keyframe, as the tracker's
    # keyframes carry theirs: the closed form of the last keyframe would
    # run across the padded gap (dt clamped to 1e-4, a velocity of ~1e4
    # m/s), a problem so ill-conditioned that the summation order of 1, 2
    # or 4 threads moves its poses by 0.03
    v_init = np.zeros((n_slots, 3), np.float32)
    v_init[[1, 3]] = true_v[[1, 3]] + 0.05
    if padded:
        v_init[:C] = true_v + 0.05
    v_ok = np.linalg.norm(v_init, axis=-1) > 1e-9
    bg0 = np.array([0.001, -0.002, 0.0], np.float32)
    ba0 = np.array([0.01, 0.0, -0.02], np.float32)
    kw = dict(bf=0.0, n_iters=6, per_kf_bias=per_kf_bias)
    rj = jvb.local_inertial_ba(m, jnp.asarray(ids), jnp.asarray(fixed), pres_j,
                               jnp.asarray(pre_valid), jnp.asarray(bg0), jnp.asarray(ba0),
                               CAM, v_init=jnp.asarray(v_init), v_init_valid=jnp.asarray(v_ok),
                               **kw)
    mt = torch_map(m)
    rt = tvb.local_inertial_ba(mt, torch.as_tensor(ids), torch.as_tensor(fixed), pres_t,
                               torch.as_tensor(pre_valid), torch.as_tensor(bg0),
                               torch.as_tensor(ba0), torch.as_tensor(np.asarray(CAM)),
                               v_init=torch.as_tensor(v_init), v_init_valid=torch.as_tensor(v_ok),
                               **kw)
    for name, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("v", 1e-3), ("bg", 1e-4), ("ba", 1e-4)):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=0, atol=tol, err_msg=name)
    R0, t0 = mt.kf_R[0].clone(), mt.kf_t[0].clone()
    m2j = jvb.apply_vi_window(m, jnp.asarray(ids), jnp.asarray(fixed), rj)
    m2t = tvb.apply_vi_window(mt, torch.as_tensor(ids), torch.as_tensor(fixed), rt)
    for name, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("kf_v", 1e-3), ("kf_bg", 1e-4),
                      ("kf_ba", 1e-4)):
        np.testing.assert_allclose(getattr(m2t, name).numpy(), np.asarray(getattr(m2j, name)),
                                   rtol=0, atol=tol, err_msg=name)
    assert torch.equal(m2t.kf_R[0], R0) and torch.equal(m2t.kf_t[0], t0)
    if padded:     # keyframe 0's velocity and bias stay as they were, as the reference's
        assert torch.equal(m2t.kf_v[0], torch.as_tensor(np.asarray(m.kf_v[0])))
    assert rt.bg.shape == ((n_slots, 3) if per_kf_bias else (3,))
    for x, y in zip(rt.last_bias, rj.last_bias):   # the newest slot's, in either mode
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-4)
    assert rt.last_bias[0].shape == (3,)
