"""BoW relocalisation of the port against the JAX reference: the P6P DLT
and PnP RANSAC (on tests/test_reloc.py's problem), the relocalisation
candidates of the keyframe database (tests/test_reloc.py's two-region world
and maps the JAX tracker's back end produced), one relocalisation attempt
against a keyframe of such a map, and both trackers on a kidnapped frame:
after 40 frames of the small orbit (period 8 s) the image of frame 2 comes
with the next timestamp.

RANSAC runs on the reference's draws (`hyp_idx`, or
`torch_parity.reference_ransac_draws`). Tolerances: ids, masks and counts
equal; scores within 1e-6; RANSAC poses within 1e-4; single DLT hypotheses
within 1e-3, translations (up to 12 m) relatively (the null vector of a
noisy 12x12 system from an f32 SVD by another LAPACK call; observed 5e-4);
relocalised poses within 1e-4 m and 1e-4 rad after two pose optimisations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms, vocabulary as jvb  # noqa: E402
from orbslam3lib_tpu.tracking import reloc as jrl, tracker as jtr  # noqa: E402
from orbslam3lib_tpu.utils import cameras as jcam, lie as jl  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms, vocabulary as tvb  # noqa: E402
from orbslam3lib_tpu_torch.tracking import reloc as trl, tracker as ttr  # noqa: E402

from torch_parity import (fast_reference_brief, loop_config,  # noqa: E402,F401
                          orbit_frames, reference_backend_snapshots, reference_draws,
                          reference_ransac_draws)
from torch_parity import reference_lie  # noqa: E402,F401

CAM = np.array([300.0, 300.0, 320.0, 200.0], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def _rot_angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)))


def pnp_problem(seed=51, n=200):
    rng = np.random.default_rng(seed)
    p_w = rng.uniform([-3, -2, 3], [3, 2, 12], size=(n, 3)).astype(np.float32)
    xi = (rng.normal(size=6) * 0.3).astype(np.float32)
    R, tt = (np.asarray(x) for x in jl.se3_exp(jnp.asarray(xi)))
    uv = np.array(jcam.pinhole_project(jnp.asarray(CAM), jnp.asarray(p_w @ R.T + tt)))
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:n // 5] += rng.uniform(30, 100, (n // 5, 2)).astype(np.float32)   # outliers
    valid = np.ones(n, bool)
    valid[-20:] = False
    return R, tt, p_w, uv, valid


def test_p6p_dlt_agrees():
    """128 samples of six distinct inliers, batched in the port, vmapped in
    the reference. (A sample with a repeated point has a null space of more
    than one dimension; LAPACK calls may return any vector of it.)"""
    _, _, p_w, uv, _ = pnp_problem()
    rng = np.random.default_rng(2)
    idx = 40 + np.stack([rng.choice(140, 6, replace=False) for _ in range(128)])
    xy = np.asarray(jcam.pinhole_unproject(jnp.asarray(CAM), jnp.asarray(uv)))[:, :2]
    Rt, tt = trl._p6p_dlt(t(p_w[idx]), t(xy[idx]))
    Rj, tj = jax.vmap(jrl._p6p_dlt)(jnp.asarray(p_w[idx]), jnp.asarray(xy[idx]))
    _close(Rt.numpy(), Rj, 1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-3, atol=1e-3)


def test_pnp_ransac_on_reference_draws():
    R, tt, p_w, uv, valid = pnp_problem()
    draws = reference_draws(valid, 128, 6)
    got = trl.pnp_ransac(t(p_w), t(uv), t(valid), t(CAM), hyp_idx=t(draws))
    want = jrl.pnp_ransac(jnp.asarray(p_w), jnp.asarray(uv), jnp.asarray(valid),
                          jnp.asarray(CAM))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3]) > 100
    _close(got[0].numpy(), want[0], 1e-4)
    _close(got[1].numpy(), want[1], 1e-4)
    assert _rot_angle(got[0].numpy(), R) < 0.02
    assert not got[2].numpy()[-20:].any()


def test_pnp_ransac_own_sampler_recovers_the_pose():
    R, tt, p_w, uv, valid = pnp_problem()
    Re, te, inl, n = trl.pnp_ransac(t(p_w), t(uv), t(valid), t(CAM))
    assert int(n) > 100 and _rot_angle(Re.numpy(), R) < 0.02
    assert np.linalg.norm(te.numpy() - tt) < 0.15


def test_detect_reloc_candidates_two_regions():
    """tests/test_reloc.py's gating case: keyframes 0-2 share region A's
    landmarks, 3-4 region B's; a region-A query returns region-A keyframes
    only, each group once, as the reference does."""
    rng = np.random.default_rng(9)
    F, P = 64, 256
    desc_a = rng.integers(0, 2, size=(F, 256)).astype(np.int8)
    desc_b = rng.integers(0, 2, size=(F, 256)).astype(np.int8)
    m = jms.empty_map(max_kf=16, max_mp=P, n_feat=F)
    fv = jnp.ones(F, bool)
    for i, (d, lo) in enumerate([(desc_a, 0)] * 3 + [(desc_b, F)] * 2):
        m, _ = jms.insert_keyframe(m, jnp.eye(3), jnp.zeros(3), jnp.float32(i),
                                   jnp.zeros((F, 2)), jnp.zeros(F, jnp.int32),
                                   jnp.asarray(d), fv,
                                   jnp.arange(lo, lo + F, dtype=jnp.int32), jnp.zeros(F))
    mp_valid = np.zeros(P, bool)
    mp_valid[:2 * F] = True
    m = m._replace(mp_valid=jnp.asarray(mp_valid))
    jv = jvb.train_vocabulary(np.concatenate([desc_a, desc_b]), k=4, depth=3)
    tv = tvb.Vocabulary(centroids=tuple(t(c) for c in jv.centroids), idf=t(jv.idf),
                        k=jv.k, depth=jv.depth)
    jpr, tpr = jrl.PlaceRecognition(jv, 16), trl.PlaceRecognition(tv, 16)
    for i in range(5):
        jpr.add(i, m.kf_desc[i], m.kf_feat_valid[i])
        tpr.add(i, t(m.kf_desc[i]), t(m.kf_feat_valid[i]))
    tm = tms.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
    for desc in (desc_a, desc_b):
        q_j = jvb.bow_from_descriptors(jv, jnp.asarray(desc), fv)
        q_t = tvb.bow_from_descriptors(tv, t(desc), torch.ones(F, dtype=torch.bool))
        _close(q_t.numpy(), q_j, 1e-7)
        ids_t, s_t = trl.detect_reloc_candidates(tm, tpr.bow_db, tpr.active, q_t)
        ids_j, s_j = jrl.detect_reloc_candidates(m, jpr.bow_db, jpr.active, q_j)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        _close(s_t.numpy(), s_j, 1e-6)
    assert np.asarray(ids_j)[0] in (3, 4)


@pytest.fixture(scope="module")
def snaps(fast_reference_brief):
    s, cfg = reference_backend_snapshots(13)
    return s, np.asarray(cfg.camera.params, np.float32)


def _frame_of_kf(m, k):
    """A keyframe's features as a frame's (xy, level, desc, valid, angle)."""
    return tuple(m[f][k] for f in ("kf_xy", "kf_level", "kf_desc", "kf_feat_valid",
                                   "kf_angle"))


@pytest.mark.parametrize("query", [1, 4])
def test_detect_reloc_candidates_on_captured_map(snaps, query):
    s, _ = snaps
    m = s[6]
    jv = jvb.load_vocabulary(jvb.DEFAULT_VOCAB_PATH)
    tv = tvb.load_vocabulary(tvb.DEFAULT_VOCAB_PATH)
    K = m["kf_R"].shape[0]
    jpr, tpr = jrl.PlaceRecognition(jv, K), trl.PlaceRecognition(tv, K)
    for i in range(6):
        jpr.add(i, jnp.asarray(m["kf_desc"][i]), jnp.asarray(m["kf_feat_valid"][i]))
        tpr.add(i, t(m["kf_desc"][i]), t(m["kf_feat_valid"][i]))
    _, _, desc, valid, _ = _frame_of_kf(m, query)
    q_j = jvb.bow_from_descriptors(jv, jnp.asarray(desc), jnp.asarray(valid))
    q_t = tvb.bow_from_descriptors(tv, t(desc), t(valid))
    ids_t, s_t = trl.detect_reloc_candidates(tms.from_numpy(m), tpr.bow_db, tpr.active, q_t)
    ids_j, s_j = jrl.detect_reloc_candidates(
        jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()}), jpr.bow_db,
        jpr.active, q_j)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    _close(s_t.numpy(), s_j, 1e-6)
    assert int(ids_j[0]) >= 0


@pytest.mark.parametrize("frame_kf,cand", [(5, 3), (6, 6)])
def test_relocalize_against_kf_on_captured_map(snaps, frame_kf, cand):
    """A keyframe's features relocalised against another keyframe of the
    map (and against itself): pose and inlier count as the reference's."""
    s, cam = snaps
    m = s[6]
    xy, lvl, desc, valid, ang = _frame_of_kf(m, frame_kf)
    kw = dict(cam_model=0, img_w=320, img_h=200, n_levels=4)
    with reference_ransac_draws():
        R_t, t_t, n_t = trl.relocalize_against_kf(
            tms.from_numpy(m), cand, t(xy), t(lvl), t(desc), t(valid), t(ang), t(cam), **kw)
    R_j, t_j, n_j = jrl.relocalize_against_kf(
        jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()}), jnp.int32(cand),
        jnp.asarray(xy), jnp.asarray(lvl), jnp.asarray(desc), jnp.asarray(valid),
        jnp.asarray(ang), jnp.asarray(cam), **kw)
    assert int(n_t) == int(n_j) >= 50
    _close(t_t.numpy(), t_j, 1e-4)
    assert _rot_angle(R_t.numpy(), np.asarray(R_j)) < 1e-4
    # the keyframe's own pose is what it relocalises to
    _close(t_t.numpy(), m["kf_t"][frame_kf], 2e-2)


N_BEFORE, KIDNAP = 40, 2


def test_trackers_relocalise_a_kidnapped_frame(fast_reference_brief):
    """40 frames of the small orbit (period 8 s: the camera turns 120
    degrees), then frame 2's image with the next timestamps and frames 3
    and 4 after it. The motion-model track and the reference-keyframe
    fallback fail on the kidnapped frame, relocalisation succeeds in both
    packages on that frame, with the same pose, close to the pose frame 2
    was tracked at (within 10 cm: a monocular PnP and pose optimisation at
    the small rig's 150 px focal length); tracking goes on from there."""
    imgs, ts, rig = orbit_frames(N_BEFORE, period=8.0)
    dt = ts[1] - ts[0]
    frames = list(zip(imgs, ts)) + [(imgs[KIDNAP + i], ts[-1] + (i + 1) * dt)
                                    for i in range(3)]
    jt = jtr.Tracker(loop_config(JCfg, rig), "stereo", enable_loop_closing=False,
                     pipeline=0)
    tt = ttr.Tracker(loop_config(TCfg, rig), "stereo", device="cpu",
                     enable_loop_closing=False)
    res = {"j": [], "t": []}
    poses = {"j": [], "t": []}
    with reference_ransac_draws():
        for img, stamp in frames:
            for key, tr in (("j", jt), ("t", tt)):
                res[key].append(tr.process_frame(img, float(stamp)))
                R, tv_ = tr.pose
                poses[key].append((np.asarray(R, np.float64), np.asarray(tv_, np.float64)))
    k = N_BEFORE
    assert [r["state"] for r in res["t"]] == [r["state"] for r in res["j"]]
    assert res["t"][k].get("reloc") and res["j"][k].get("reloc")
    assert tt.stats["n_reloc"] == jt.stats["n_reloc"] == 1
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 1
    assert res["t"][k]["n_inliers"] == res["j"][k]["n_inliers"] >= 50
    assert all(r["state"] == ttr.OK for r in res["t"][k:])
    (Rt, t_), (Rj, tj) = poses["t"][k], poses["j"][k]
    assert np.linalg.norm(Rt.T @ t_ - Rj.T @ tj) < 1e-4 and _rot_angle(Rt, Rj) < 1e-4
    R2, t2 = poses["t"][KIDNAP]
    assert np.linalg.norm(Rt.T @ t_ - R2.T @ t2) < 0.1
