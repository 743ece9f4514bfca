"""Stereo matching, projection search, pose optimisation, the two-stage
track, the reference-keyframe fallback and keyframe insertion of the port
against the JAX reference, from one map: the reference builds it with its
own `_insert_kf_and_spawn` and `map_state.from_numpy` carries it into the
port. Both packages get the same features (the reference's extraction of
the same rendered frames), so every difference is the module under test."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.models import map_state as jms  # noqa: E402
from orbslam3lib_tpu.ops import extractor as jex  # noqa: E402
from orbslam3lib_tpu.tracking import matching as jmt, pose_opt as jpo  # noqa: E402
from orbslam3lib_tpu.tracking import reloc as jrl, tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402
from orbslam3lib_tpu_torch.tracking import matching as tmt, pose_opt as tpo  # noqa: E402
from orbslam3lib_tpu_torch.tracking import reloc as trl, tracker as ttr  # noqa: E402

from torch_parity import fast_reference_brief, orbit_frames  # noqa: E402,F401
from torch_parity import reference_lie  # noqa: E402,F401

N_LEVELS, MAX_KP = 4, 256
TRACK = dict(r_coarse=7.0, r_fine=3.0, cam_model=0, img_w=320, img_h=200,
             n_levels=N_LEVELS, pose_rounds=2, pose_iters=2)


def T(x):
    """numpy/JAX array -> torch tensor (same dtype)."""
    return torch.from_numpy(np.array(x))


def _frame(img):
    f, canvas = jex.extract_orb_stereo(jnp.asarray(img), jnp.float32(12.0),
                                       max_kp=MAX_KP, n_levels=N_LEVELS,
                                       return_canvas=True)
    return f, canvas


@pytest.fixture(scope="module")
def scene(fast_reference_brief):
    imgs, ts, rig = orbit_frames(5)
    cam = np.array([rig.fx, rig.fy, rig.cx, rig.cy], np.float32)
    bf = float(rig.fx * rig.baseline)
    frames = []
    for i in (0, 4):
        f, canvas = _frame(imgs[i])
        u_r, depth = jmt.match_rectified_stereo(
            f.xy[0], f.level[0], f.desc[0], f.valid[0], f.xy[1], f.level[1],
            f.desc[1], f.valid[1], bf, 0.3, n_levels=N_LEVELS)
        u_r, depth = jmt.refine_stereo_sad(
            canvas[0], canvas[1], f.xy[0], f.level[0], f.valid[0], u_r, depth,
            bf=bf, min_z=0.3, n_levels=N_LEVELS)
        frames.append((f, canvas, u_r, depth))
    f0, _, u0, d0 = frames[0]
    m0 = jms.empty_map(16, 2048, MAX_KP)
    jmap, _ = jtr._insert_kf_and_spawn(
        m0, jnp.eye(3), jnp.zeros(3), jnp.float32(0.0), f0.xy[0], f0.level[0],
        f0.desc[0], f0.valid[0], u0, d0, jnp.full(2048, -1, jnp.int32),
        jnp.asarray(cam), 1e9, cam_model=0, n_levels=N_LEVELS,
        angle=f0.angle[0], img_w=rig.width, img_h=rig.height)
    # frame 4's true pose relative to frame 0 (Tcw with frame 0 as world)
    from orbslam3lib_tpu_torch.io.synthetic import orbit_pose_at
    Rw, cw = orbit_pose_at(ts[[0, 4]])
    R0, R4 = Rw[0].T, Rw[1].T                       # world -> cam rotations
    R = (R4 @ R0.T).astype(np.float32)
    t = (R4 @ (cw[0] - cw[1])).astype(np.float32)
    return dict(cam=cam, bf=bf, jmap=jmap, frames=frames, R=R, t=t, rig=rig)


def _np_map(m):
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def test_map_state_round_trip(scene):
    arrays = _np_map(scene["jmap"])
    tm = tms.from_numpy(arrays)
    back = tms.to_numpy(tm)
    assert list(back) == list(arrays)          # same fields, same order
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    assert (tm.max_kf, tm.max_mp, tm.n_feat) == (16, 2048, MAX_KP)
    e_t, e_j = tms.to_numpy(tms.empty_map(4, 32, 8)), _np_map(jms.empty_map(4, 32, 8))
    for k in e_j:
        assert e_t[k].dtype == e_j[k].dtype, k
        np.testing.assert_array_equal(e_t[k], e_j[k])
    O_t = tms.observation_matrix(tm).numpy()
    np.testing.assert_array_equal(O_t, np.asarray(jms.observation_matrix(scene["jmap"])))


def test_rectified_stereo_and_sad(scene):
    """Rectified matches are exact (integer Hamming distances, the same f32
    gate arithmetic): u_right equal, depth to 1e-6 relative. SAD refinement
    sums 121 f32 differences in another order: u_right/depth within 1e-4."""
    f, canvas, u_ref, d_ref = scene["frames"][1]
    bf = scene["bf"]
    args = [T(a) for a in (f.xy[0], f.level[0], f.desc[0], f.valid[0],
                           f.xy[1], f.level[1], f.desc[1], f.valid[1])]
    u_t, d_t = tmt.match_rectified_stereo(*args, bf, 0.3, n_levels=N_LEVELS)
    u_j, d_j = jmt.match_rectified_stereo(
        f.xy[0], f.level[0], f.desc[0], f.valid[0], f.xy[1], f.level[1],
        f.desc[1], f.valid[1], bf, 0.3, n_levels=N_LEVELS)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=0)
    assert (u_t.numpy() >= 0).sum() > 50
    u2, d2 = tmt.refine_stereo_sad(T(canvas[0]), T(canvas[1]), args[0], args[1],
                                   args[3], u_t, d_t, bf=bf, min_z=0.3,
                                   n_levels=N_LEVELS)
    np.testing.assert_allclose(u2.numpy(), np.asarray(u_ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(d2.numpy(), np.asarray(d_ref), rtol=0, atol=1e-4)


def test_search_by_projection(scene):
    """mp_feat equal; visible (a product of soft f32 gates) within 1e-6."""
    f, _, _, _ = scene["frames"][1]
    jm, cam = scene["jmap"], scene["cam"]
    tm = tms.from_numpy(_np_map(jm))
    kw = dict(radius=7.0, cam_model=0, img_w=320, img_h=200, n_levels=N_LEVELS)
    pj = jmt.search_by_projection(
        jm.mp_pos, jm.mp_desc, jm.mp_valid, jm.mp_normal, jm.mp_min_dist,
        jm.mp_max_dist, jnp.asarray(scene["R"]), jnp.asarray(scene["t"]),
        jnp.asarray(cam), f.xy[0], f.level[0], f.desc[0], f.valid[0], **kw)
    pt = tmt.search_by_projection(
        tm.mp_pos, tm.mp_desc, tm.mp_valid, tm.mp_normal, tm.mp_min_dist,
        tm.mp_max_dist, T(scene["R"]), T(scene["t"]), T(cam), T(f.xy[0]),
        T(f.level[0]), T(f.desc[0]), T(f.valid[0]), **kw)
    np.testing.assert_array_equal(pt.mp_feat.numpy(), np.asarray(pj.mp_feat))
    np.testing.assert_allclose(pt.visible.numpy(), np.asarray(pj.visible), rtol=0, atol=1e-6)
    assert (pt.mp_feat.numpy() >= 0).sum() > 50


def _obs_from(scene):
    """One observation set for both solvers: the reference's projection
    matches at the true pose, perturbed start pose."""
    f, _, u_r, depth = scene["frames"][1]
    jm = scene["jmap"]
    pm = jmt.search_by_projection(
        jm.mp_pos, jm.mp_desc, jm.mp_valid, jm.mp_normal, jm.mp_min_dist,
        jm.mp_max_dist, jnp.asarray(scene["R"]), jnp.asarray(scene["t"]),
        jnp.asarray(scene["cam"]), f.xy[0], f.level[0], f.desc[0], f.valid[0],
        radius=7.0, cam_model=0, img_w=320, img_h=200, n_levels=N_LEVELS)
    F = MAX_KP
    mp_feat = np.asarray(pm.mp_feat)
    feat_mp = np.full(F, -1, np.int64)
    feat_mp[mp_feat[mp_feat >= 0]] = np.flatnonzero(mp_feat >= 0)
    has = feat_mp >= 0
    d = np.asarray(depth)
    from orbslam3lib_tpu.mapping.map_ba import inv_sigma2
    fields = dict(p_world=np.asarray(jm.mp_pos)[np.clip(feat_mp, 0, None)],
                  uv=np.asarray(f.xy[0]),
                  inv_sigma2=np.asarray(inv_sigma2(f.level[0], N_LEVELS)),
                  u_right=np.where(d > 0, np.asarray(u_r), 0.0).astype(np.float32),
                  is_stereo=has & (d > 0), valid=has)
    return fields


def test_pose_optimization(scene):
    """Same observations, same start: GN in f32 on both sides; the 6x6
    solve and the sums round differently, so poses agree to 1e-5 (rotation
    entries, metres), and the inlier sets are equal."""
    obs = _obs_from(scene)
    rng = np.random.default_rng(9)
    R0 = (scene["R"] @ jnp.asarray(np.eye(3))).astype(np.float32)
    t0 = (scene["t"] + rng.normal(0, 0.02, 3)).astype(np.float32)
    cam, bf = scene["cam"], scene["bf"]
    Rj, tj, inl_j, n_j = jpo.pose_optimization(
        jnp.asarray(R0), jnp.asarray(t0),
        jpo.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
        jnp.asarray(cam), bf=bf, n_rounds=4, iters_per_round=10)
    Rt, tt, inl_t, n_t = tpo.pose_optimization(
        T(R0), T(t0), tpo.PoseObs(**{k: T(v) for k, v in obs.items()}),
        T(cam), bf=bf, n_rounds=4, iters_per_round=10)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) > 50
    # and lands near the true pose (the map carries the stereo depth error
    # of a 320x200 rig: a few cm)
    np.testing.assert_allclose(tt.numpy(), scene["t"], atol=0.05)


@pytest.mark.parametrize("use_prev", [False, True])
def test_two_stage_core(scene, use_prev):
    """The whole per-frame track from a motion-model guess (the true pose
    off by 2 cm and 0.6 degrees), with and without the previous frame's
    bindings (stage-1 restriction and local map). Poses within 1e-4 (f32 GN
    over two searches), the same landmark matches and inlier count."""
    f, _, u_r, depth = scene["frames"][1]
    jm, cam, bf = scene["jmap"], scene["cam"], scene["bf"]
    tm = tms.from_numpy(_np_map(jm))
    prev = np.asarray(jm.kf_mp[0]) if use_prev else None
    prev_ang = np.asarray(jm.kf_angle[0]) if use_prev else None
    ang = f.angle[0] if use_prev else None
    from orbslam3lib_tpu_torch.utils.lie import so3_exp
    R0 = (so3_exp(torch.tensor([0.0, 0.01, 0.0])).numpy() @ scene["R"]).astype(np.float32)
    t0 = (scene["t"] + np.array([0.02, 0.0, -0.01])).astype(np.float32)
    out_j = jtr._two_stage_core(
        jm, jnp.asarray(R0), jnp.asarray(t0), f.xy[0], f.level[0], f.desc[0], f.valid[0],
        u_r, depth, jnp.asarray(cam), bf,
        prev_mp=None if prev is None else jnp.asarray(prev),
        prev_angle=None if prev is None else jnp.asarray(prev_ang),
        feat_angle=ang, local_only=use_prev, **TRACK)
    out_t = ttr._two_stage_core(
        tm, T(R0), T(t0), T(f.xy[0]), T(f.level[0]), T(f.desc[0]),
        T(f.valid[0]), T(u_r), T(depth), T(cam), bf,
        prev_mp=None if prev is None else T(prev),
        prev_angle=None if prev is None else T(prev_ang),
        feat_angle=None if ang is None else T(ang), local_only=use_prev, **TRACK)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    assert int(out_t[4]) == int(out_j[4]) > 50
    np.testing.assert_allclose(out_t[5].numpy(), np.asarray(out_j[5]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out_t[8].numpy(), np.asarray(out_j[8]))


def test_track_reference_kf(scene):
    """The fallback (descriptor kNN-2 + ratio against the keyframe, rotation
    histogram, pose LM from the last pose): poses within 1e-4, equal
    inlier counts. On CPU tensors the port runs kernel 2's plain version."""
    f, _, u_r, depth = scene["frames"][1]
    jm, cam, bf = scene["jmap"], scene["cam"], scene["bf"]
    tm = tms.from_numpy(_np_map(jm))
    Rj, tj, nj = jrl.track_reference_kf(
        jm, jnp.int32(0), jnp.eye(3), jnp.zeros(3), f.xy[0], f.level[0],
        f.desc[0], f.valid[0], f.angle[0], u_r, depth, jnp.asarray(cam),
        cam_model=0, bf=bf, n_levels=N_LEVELS)
    Rt, tt, nt = trl.track_reference_kf(
        tm, 0, torch.eye(3), torch.zeros(3), T(f.xy[0]), T(f.level[0]),
        T(f.desc[0]), T(f.valid[0]), T(f.angle[0]), T(u_r), T(depth), T(cam),
        cam_model=0, bf=bf, n_levels=N_LEVELS)
    assert int(nt) == int(nj) > 30
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-4)


def test_insert_kf_and_spawn(scene):
    """Keyframe insertion with landmark binding, re-association and stereo
    spawning, into the reference map, from the same tracked frame: the
    resulting maps are equal field by field (ids, masks and descriptors
    exactly; positions and other f32 geometry within 1e-5)."""
    f, _, u_r, depth = scene["frames"][1]
    jm, cam = scene["jmap"], scene["cam"]
    R, t = scene["R"], scene["t"]
    pm = jmt.search_by_projection(
        jm.mp_pos, jm.mp_desc, jm.mp_valid, jm.mp_normal, jm.mp_min_dist,
        jm.mp_max_dist, jnp.asarray(R), jnp.asarray(t), jnp.asarray(cam),
        f.xy[0], f.level[0], f.desc[0], f.valid[0], radius=3.0, cam_model=0,
        img_w=320, img_h=200, n_levels=N_LEVELS)
    close = 40.0 * scene["rig"].baseline
    kw = dict(cam_model=0, n_levels=N_LEVELS, img_w=320, img_h=200)
    v = np.array([0.1, 0.0, -0.2], np.float32)
    j2, kj = jtr._insert_kf_and_spawn(
        jm, jnp.asarray(R), jnp.asarray(t), jnp.float32(0.25), f.xy[0],
        f.level[0], f.desc[0], f.valid[0], u_r, depth, pm.mp_feat,
        jnp.asarray(cam), close, v=jnp.asarray(v), angle=f.angle[0], **kw)
    tm = tms.from_numpy(_np_map(jm))
    t2, kt = ttr._insert_kf_and_spawn(
        tm, T(R), T(t), 0.25, T(f.xy[0]), T(f.level[0]), T(f.desc[0]),
        T(f.valid[0]), T(u_r), T(depth), T(pm.mp_feat), T(cam), close,
        v=T(v), angle=T(f.angle[0]), **kw)
    assert kt == int(kj) == 1
    got, want = tms.to_numpy(t2), _np_map(j2)
    assert int(want["n_mp"]) > int(np.asarray(jm.n_mp))
    for k, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
