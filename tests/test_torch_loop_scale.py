"""The free-scale loop leg of monocular SLAM, the port against the JAX
reference, on tests/test_loop_closing.py's drifted ring world
(`torch_parity.ring_world`) with the revisiting keyframe's own landmarks
shrunk by S_DRIFT about its camera centre (and its stereo depths with
them): the scale drift a monocular map accumulates around a loop.

`verify_loop_fused(fix_scale=False)` finds the Sim(3) with s = S_DRIFT in
both packages (the reference's RANSAC draws; ids and counts equal, the
Sim(3) within 1e-4). `LoopCloser(fix_scale=False).correct` with that s
runs the essential graph in Sim(3) and writes the poses back: equal within
1e-4.

A fault of the reference shows here: its `apply_pose_graph_result`
(loop_closing.py:437-453) takes each landmark through its keyframe's
corrected pose without the corrected Sim(3)'s scale (p' = R^T (p_c - t/s)
where CorrectLoop has R^T (p_c - t) / s), so the keyframes take the new
scale and their landmarks keep the old one: the revisit's landmarks stay
as far from the first keyframes' copies of the same points as before the
correction. The port scales them (`scale_points` when the closer's scale
is free); with the reference's behaviour put back
(`torch_parity.reference_unscaled_points`) its landmarks equal the reference's within
1e-4. Held on the landmarks anchored at the fixed loop keyframe (equal in
both) and at the revisit (the port's lie 1/s_k as far from their
keyframe's centre, one s_k for all of them).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.mapping import loop_closing as jlc  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.mapping import loop_closing as tlc  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402

from torch_parity import (RING_CAM as CAM, reference_draws,  # noqa: E402
                          reference_unscaled_points, ring_world)

LAST = 12
S_DRIFT = 0.8
KW = dict(cam_model=0, img_w=640, img_h=400, n_levels=8)


@pytest.fixture(scope="module")
def drifted():
    m, _, descs = ring_world()
    R, t = m["kf_R"][LAST], m["kf_t"][LAST]
    c = -R.T @ t
    own = np.nonzero(m["mp_valid"] & (m["mp_first_kf"] == LAST))[0]
    m["mp_pos"][own] = c + S_DRIFT * (m["mp_pos"][own] - c)
    m["kf_depth"][LAST] *= S_DRIFT
    # each of the revisit's landmarks and the first keyframes' copy of it
    first = {tuple(m["mp_desc"][p]): p for p in np.nonzero(m["mp_valid"])[0]
             if m["mp_first_kf"][p] != LAST}
    pairs = np.array([(p, first[tuple(m["mp_desc"][p])]) for p in own])
    return m, pairs


def _jmap(m):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()})


def _pack(m):
    valid = np.asarray(jlc.match_kf_landmarks(_jmap(m), jnp.int32(LAST), jnp.int32(0))[4])
    draws = reference_draws(valid, 128, 3)
    want = np.asarray(jlc.verify_loop_fused(_jmap(m), jnp.int32(LAST), jnp.int32(0),
                                            jnp.asarray(CAM), fix_scale=False, **KW))
    got = tlc.verify_loop_fused(tms.from_numpy(m), LAST, 0, torch.from_numpy(CAM),
                                fix_scale=False, hyp_idx=torch.from_numpy(draws), **KW)
    return got.numpy(), want


def test_verify_finds_the_scale(drifted):
    m, _ = drifted
    got, want = _pack(m)
    np.testing.assert_array_equal(got[:5], want[:5])
    np.testing.assert_allclose(got[5:], want[5:], rtol=0, atol=1e-4)
    assert want[1] >= 15 and want[3] >= 20
    assert abs(want[17] - S_DRIFT) < 1e-3


def _correct(m, pkg, S12, unscaled=False):
    if pkg == "j":
        out = jlc.LoopCloser(JCfg(), None, fix_scale=False).correct(
            _jmap(m), LAST, 0, tuple(jnp.asarray(x, jnp.float32) for x in S12))
        return {k: np.asarray(getattr(out, k)) for k in ("kf_R", "kf_t", "mp_pos")}
    ctx = reference_unscaled_points() if unscaled else contextlib.nullcontext()
    with ctx:
        out = tlc.LoopCloser(TCfg(), None, fix_scale=False).correct(
            tms.from_numpy(m), LAST, 0, tuple(torch.tensor(np.float32(x)) for x in S12))
    return {k: getattr(out, k).numpy() for k in ("kf_R", "kf_t", "mp_pos")}


@pytest.fixture(scope="module")
def corrected(drifted):
    m, _ = drifted
    _, pack = _pack(m)
    S12 = (pack[5:14].reshape(3, 3), pack[14:17], pack[17])
    return {"j": _correct(m, "j", S12), "t": _correct(m, "t", S12),
            "t_fault": _correct(m, "t", S12, unscaled=True)}


def test_correction_poses_agree(corrected):
    j, t = corrected["j"], corrected["t"]
    for k in ("kf_R", "kf_t"):
        np.testing.assert_allclose(t[k][:LAST + 1], j[k][:LAST + 1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(corrected["t_fault"]["mp_pos"], j["mp_pos"], rtol=0, atol=1e-4)


def test_reference_leaves_the_landmarks_unscaled(drifted, corrected):
    m, pairs = drifted
    j, t = corrected["j"], corrected["t"]
    anchor = m["mp_first_kf"]
    at0 = m["mp_valid"] & (anchor == 0)
    np.testing.assert_allclose(t["mp_pos"][at0], j["mp_pos"][at0], rtol=0, atol=1e-4)
    # the revisit's landmarks, about its corrected centre: one scale apart
    own = pairs[:, 0]
    c = -t["kf_R"][LAST].T @ t["kf_t"][LAST]
    ratio = np.linalg.norm(t["mp_pos"][own] - c, axis=1) / \
        np.linalg.norm(j["mp_pos"][own] - c, axis=1)
    assert np.ptp(ratio) < 1e-4 and ratio.mean() > 1.1, (ratio.mean(), np.ptp(ratio))

    def gap(pos):
        return np.median(np.linalg.norm(pos[pairs[:, 0]] - pos[pairs[:, 1]], axis=1))
    before = gap(m["mp_pos"])
    assert gap(j["mp_pos"]) > 0.95 * before           # the reference: no closer
    assert gap(t["mp_pos"]) < 0.5 * before            # the port: the copies meet
