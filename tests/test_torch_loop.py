"""Loop detection, verification and correction of the port against the JAX
reference, module by module.

On tests/test_loop_closing.py's drifted ring world (13 keyframes on a
circle looking out at a landmark wall, drifted poses, the last keyframe
revisiting the first with duplicate landmarks): `match_kf_landmarks`,
`search_by_sim3`, `project_count_sim3`, `essential_edges`, the 24-float
pack of `verify_loop_fused` and `LoopCloser.on_probe_result` closing the
loop (essential graph, landmark re-anchoring, global BA). On the maps the
JAX tracker's back end produced (`torch_parity.reference_backend_snapshots`):
`loop_probe` and `mapper_step_fused(with_probe=True)`.

RANSAC runs on the reference's draws (`hyp_idx`, or
`torch_parity.reference_ransac_draws`). Tolerances: ids, masks and counts
equal; BoW scores within 1e-6; camera-frame points within 1e-5; the Sim3
of the pack within 1e-4; corrected poses and landmarks within 1e-4 (a 15-step
pose graph and ten LM steps of global BA in f32, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.mapping import loop_closing as jlc, sim3 as jsim  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms, vocabulary as jvb  # noqa: E402
from orbslam3lib_tpu.tracking.reloc import PlaceRecognition as JPR  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.mapping import loop_closing as tlc  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms, vocabulary as tvb  # noqa: E402
from orbslam3lib_tpu_torch.tracking.reloc import PlaceRecognition as TPR  # noqa: E402

from torch_parity import (RING_CAM as CAM, fast_reference_brief,  # noqa: E402,F401
                          reference_backend_snapshots, reference_draws,
                          reference_ransac_draws, reference_single_device_gba,
                          reference_unscaled_points, ring_world)

KW = dict(cam_model=0, img_w=640, img_h=400, n_levels=8)


@pytest.fixture(scope="module")
def ring():
    return ring_world()


def jmap(arrays):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol, err_msg=msg)


LAST = 12


def test_match_kf_landmarks(ring):
    m = ring[0]
    got = tlc.match_kf_landmarks(tms.from_numpy(m), LAST, 0)
    want = jlc.match_kf_landmarks(jmap(m), jnp.int32(LAST), jnp.int32(0))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    assert int(want[4].sum()) > 40
    for a, b in zip(got[:4], want[:4]):
        _close(a.numpy()[np.asarray(want[4])], np.asarray(b)[np.asarray(want[4])], 1e-5)


def _ransac(m, fix_scale=False):
    """The reference's Sim3 RANSAC between the revisit and keyframe 0, and
    its draws."""
    jm = jmap(m)
    p_a, p_b, uv_a, uv_b, valid, idx = jlc.match_kf_landmarks(jm, jnp.int32(LAST), jnp.int32(0))
    draws = reference_draws(np.asarray(valid), 128, 3)
    out = jsim.sim3_ransac(p_a, p_b, uv_a, uv_b, valid, jnp.asarray(CAM), fix_scale=fix_scale)
    return out, idx, valid, draws


def test_search_by_sim3_and_projection_counts(ring):
    m = ring[0]
    (R12, t12, s12, inl, n_inl), idx, valid, _ = _ransac(m)
    assert int(n_inl) >= 10
    tm, jm = tms.from_numpy(m), jmap(m)
    seeds = inl & valid
    for prev_idx, prev_ok in ((idx, seeds), (jnp.full_like(idx, -1), jnp.zeros_like(seeds))):
        got = tlc.search_by_sim3(tm, LAST, 0, t(R12), t(t12), t(s12), t(CAM),
                                 t(prev_idx), t(prev_ok))
        want = jlc.search_by_sim3(jm, jnp.int32(LAST), jnp.int32(0), R12, t12, s12,
                                  jnp.asarray(CAM), prev_idx, prev_ok)
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        for a, b in zip(got[:4], want[:4]):
            _close(a.numpy(), b, 1e-5)
        assert int(want[4].sum()) >= 10
    for radius in (8.0, 5.0):
        n_t = tlc.project_count_sim3(tm, LAST, 0, t(R12), t(t12), t(s12), t(CAM),
                                     radius=radius, **KW)
        n_j = jlc.project_count_sim3(jm, jnp.int32(LAST), jnp.int32(0), R12, t12, s12,
                                     jnp.asarray(CAM), radius=radius, **KW)
        assert int(n_t) == int(n_j) > 20


def test_essential_edges(ring):
    m = ring[0]
    for e_max in (1024, 40):
        got = tlc.essential_edges(tms.from_numpy(m), e_max=e_max)
        want = jlc.essential_edges(jmap(m), e_max=e_max)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_verify_loop_fused_pack(ring, fix_scale):
    m = ring[0]
    _, _, valid, draws = _ransac(m)
    got = tlc.verify_loop_fused(tms.from_numpy(m), LAST, 0, t(CAM), fix_scale=fix_scale,
                                hyp_idx=t(draws), **KW).numpy()
    want = np.asarray(jlc.verify_loop_fused(jmap(m), jnp.int32(LAST), jnp.int32(0),
                                            jnp.asarray(CAM), fix_scale=fix_scale, **KW))
    np.testing.assert_array_equal(got[:5], want[:5])
    assert want[1] >= 15 and want[3] >= 20
    _close(got[5:], want[5:], 1e-4)


@pytest.mark.parametrize("inertial", [False, True])
def test_loop_closer_closes_the_loop(ring, inertial):
    """LoopCloser.on_probe_result with the reference's probe pack (the
    revisit's candidates) and one coincidence needed: both verify, correct
    (essential graph and landmark re-anchoring) and run the global BA; the
    corrected poses and landmarks agree and the drift shrinks. Inertial
    (the gates of LoopClosing.cc:144-163 and the 4-DoF graph): both take
    the same decision, and agree as above when they correct. The closers'
    scale is free here (their default), so the port runs with the
    reference's unscaled landmark correction put back
    (`torch_parity.reference_unscaled_points`; the fault is held in
    test_torch_loop_scale.py)."""
    m, true, descs = ring
    jv = jvb.train_vocabulary(descs, k=4, depth=3)
    tv = tvb.Vocabulary(centroids=tuple(t(c) for c in jv.centroids), idf=t(jv.idf),
                        k=jv.k, depth=jv.depth)
    jpr, tpr = JPR(jv, max_kf=32), TPR(tv, max_kf=32)
    for i in range(LAST + 1):
        jpr.add(i, jnp.asarray(m["kf_desc"][i]), jnp.asarray(m["kf_feat_valid"][i]))
        tpr.add(i, t(m["kf_desc"][i]), t(m["kf_feat_valid"][i]))
    jm = jmap(m)
    pack = np.asarray(jlc.loop_probe(jm, jpr.bow_db, jpr.active, jv.centroids, jv.idf,
                                     jnp.int32(LAST), k=jv.k, depth=jv.depth,
                                     prev_cand=jnp.int32(-1)))
    assert int(pack[0]) == 0
    jlcr = jlc.LoopCloser(JCfg(), jpr, consistency_needed=1)
    tlcr = tlc.LoopCloser(TCfg(), tpr, consistency_needed=1)
    jlcr.inertial = tlcr.inertial = inertial
    with reference_single_device_gba():
        want = jlcr.on_probe_result(jm, LAST, pack, jnp.asarray(CAM))
    with reference_ransac_draws(), reference_unscaled_points():
        got = tlcr.on_probe_result(tms.from_numpy(m), LAST, pack, t(CAM))
    assert tlcr.n_loops == jlcr.n_loops
    assert tlcr.consistency_count == jlcr.consistency_count
    assert tlcr.loop_edges == jlcr.loop_edges
    for f in ("kf_R", "kf_t", "mp_pos"):
        _close(getattr(got, f).numpy(), getattr(want, f), 1e-4, f)
    if inertial and not jlcr.n_loops:
        return
    assert jlcr.n_loops == 1 and jlcr.loop_edges == [(0, LAST)]
    for a, b in zip(tlcr.last_delta, jlcr.last_delta):
        _close(a.numpy(), b, 1e-4)

    def err(R, tt):
        return np.array([np.linalg.norm(-R[i].T @ tt[i] + true[i][0].T @ true[i][1])
                         for i in range(LAST + 1)])
    before = err(m["kf_R"], m["kf_t"])
    after = err(got.kf_R.numpy(), got.kf_t.numpy())
    assert after[-1] < 0.5 * before[-1] and after.mean() < before.mean()


def test_loop_edges_follow_a_keyframe_remap():
    """`remap_keyframes` (after a compaction re-indexes the slots): edges
    move with their keyframes, edges touching a dropped one go."""
    kf_new = np.array([0, -1, 1, 2, 3, -1, 4], np.int32)
    closers = [jlc.LoopCloser(JCfg(), None), tlc.LoopCloser(TCfg(), None)]
    for c in closers:
        c.loop_edges = [(0, 6), (1, 4), (2, 3), (5, 9)]
        c.remap_keyframes(kf_new)
    assert closers[1].loop_edges == closers[0].loop_edges == [(0, 4), (1, 2)]


# -- the probe on maps from a real run -----------------------------------------

@pytest.fixture(scope="module")
def snaps(fast_reference_brief):
    s, cfg = reference_backend_snapshots(13)
    return s, np.asarray(cfg.camera.params, np.float32)


def _db(m, jv, tv, upto):
    jpr, tpr = JPR(jv, m["kf_R"].shape[0]), TPR(tv, m["kf_R"].shape[0])
    for i in range(upto):
        if m["kf_valid"][i]:
            jpr.add(i, jnp.asarray(m["kf_desc"][i]), jnp.asarray(m["kf_feat_valid"][i]))
            tpr.add(i, t(m["kf_desc"][i]), t(m["kf_feat_valid"][i]))
    return jpr, tpr


@pytest.mark.parametrize("kid,prev", [(6, -1), (6, 2), (3, 0)])
def test_loop_probe_on_captured_maps(snaps, kid, prev):
    """The probe pack: candidate ids, covisibility weights, n_bow equal
    (here every keyframe is within 8 ids, so all candidates tie at -1 and
    the tie order is what is held), scores and the floor within 1e-6."""
    s, _ = snaps
    m = s[kid]
    jv = jvb.load_vocabulary(jvb.DEFAULT_VOCAB_PATH)
    tv = tvb.load_vocabulary(tvb.DEFAULT_VOCAB_PATH)
    jpr, tpr = _db(m, jv, tv, kid + 1)
    got = tlc.loop_probe(tms.from_numpy(m), tpr.bow_db, tpr.active, tv.centroids, tv.idf,
                         kid, k=tv.k, depth=tv.depth, prev_cand=prev).numpy()
    want = np.asarray(jlc.loop_probe(jmap(m), jpr.bow_db, jpr.active, jv.centroids, jv.idf,
                                     jnp.int32(kid), k=jv.k, depth=jv.depth,
                                     prev_cand=jnp.int32(prev)))
    n = 3
    np.testing.assert_array_equal(got[:n], want[:n])
    np.testing.assert_array_equal(got[2 * n:3 * n], want[2 * n:3 * n])
    assert got[3 * n + 1] == want[3 * n + 1] > 0              # n_bow
    _close(got[n:2 * n], want[n:2 * n], 1e-6)
    _close(got[3 * n], want[3 * n], 1e-6)
