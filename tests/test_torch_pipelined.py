"""The pipelined tracker of the port against the JAX reference's, on the
CPU, with mapping inline (no mapper thread) so that both are
deterministic: `Tracker(cfg, "stereo", pipeline=6, chunk=2)` on the
40-frame corridor sequence and `small_config` of
tests/test_pipelined_tracker.py, loop closing off as there.

The reference reads each chunk's packs on a background fetch pool, so how
many chunks one of its batches consumes depends on that thread's timing;
here its fetches run when submitted (`torch_parity.InlineFetches`), as the
port's reads do on the CPU, and both consume each chunk right after it
is dispatched.

Checked, frame by frame: the state each `process_frame` returns, the
keyframes made so far and the last keyframe's frame, the FAST threshold
(one controller step per consumed batch) and the trajectory's length;
then every pose within 1e-4 m (camera centre) and 1e-4 rad, and the
keyframes' poses the same way (f32 solves summed in another order over 40
frames). The blinded burst of tests/test_pipelined_tracker.py
(`test_loss_in_burst_drains_to_sync`): the same failures, states and
poses. And `_frame_body` alone, on a captured map: the 16-float pack
(counts equal, pose to 1e-5), the keyframe inputs (integers equal, angles
to 1e-4 rad, the right-eye x and the depth to 1e-5 relative, the
keypoints to 1e-5 px), the landmark statistics to 1e-6 and the
bindings equal, once from a re-seeded chain (no bindings: the local map
comes from the reference keyframe, `_local_map_mask(..., ref_kf)`) and once
from the bindings that frame left.

Named exception: the reference pads a drain's short chunk with copies of
its last frame (its `lax.scan` has a static length), and the copy counts
that frame's landmark visibility once more; the port dispatches only the
buffered frames. The 40-frame run's only short chunk is its final drain,
so the landmark statistics are not compared after it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.models import map_state as jms  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.io.synthetic import render_stereo_sequence  # noqa: E402
from orbslam3lib_tpu_torch.models import map_state as tms  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402

from torch_parity import InlineFetches, fast_reference_brief  # noqa: E402,F401
from torch_parity import reference_lie  # noqa: E402,F401


def small_config(cfg_cls, rig):
    """tests/test_pipelined_tracker.py's configuration."""
    cfg = cfg_cls()
    cfg.map.max_kf = 64
    cfg.map.max_mp = 4096
    cfg.orb.max_kp = 384
    cfg.orb.target_features = 300
    cfg.orb.fast_threshold = 12.0
    cfg.tracker.min_init_features = 150
    cfg.ba.max_points = 1024
    cfg.ba.window_size = 6
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    return cfg


@pytest.fixture(scope="module")
def sequence():
    return render_stereo_sequence(n_frames=40, dt=1.0 / 15.0, seed=5)


def _trackers(rig):
    kw = dict(enable_loop_closing=False, pipeline=6, chunk=2)
    jt = jtr.Tracker(small_config(JCfg, rig), "stereo", **kw)
    jt._fetch_pool = InlineFetches()
    return jt, ttr.Tracker(small_config(TCfg, rig), "stereo", device="cpu", **kw)


def _drive(tr, frames):
    rec = []
    for img, stamp in frames:
        res = tr.process_frame(img, stamp)
        rec.append((int(res["state"]), tr.stats["n_kf"], tr.last_kf_frame,
                    tr.stats["track_fail"], float(tr.threshold.t), len(tr.trajectory)))
    tr.finish()
    rec.append((int(tr.state), tr.stats["n_kf"], tr.last_kf_frame, tr.stats["track_fail"],
                float(tr.threshold.t), len(tr.trajectory)))
    return rec


@pytest.fixture(scope="module")
def runs(sequence, fast_reference_brief):
    frames, rig, _ = sequence
    jt, tt = _trackers(rig)
    feed = [(img, stamp) for img, _, stamp in frames]
    return _drive(jt, feed), _drive(tt, feed), jt, tt


def _pose_close(traj_a, traj_b, atol=1e-4):
    assert [f[0] for f in traj_a] == [f[0] for f in traj_b]
    for (_, Ra, ta), (_, Rb, tb) in zip(traj_a, traj_b):
        Ra, Rb = np.asarray(Ra, np.float64), np.asarray(Rb, np.float64)
        ca, cb = -Ra.T @ np.asarray(ta), -Rb.T @ np.asarray(tb)
        assert np.linalg.norm(ca - cb) < atol
        D = Ra.T @ Rb                 # the angle from its skew part (arccos of the
        ang = np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],   # trace is
                              D[1, 0] - D[0, 1]]) / 2.0               # ~1e-4 at 1 ulp)
        assert ang < atol


def test_states_keyframes_and_thresholds(runs):
    rec_j, rec_t, jt, tt = runs
    assert rec_t == rec_j
    assert tt.state == ttr.OK and tt.stats["track_fail"] == 0
    assert tt.stats["n_kf"] >= 2 and len(tt.trajectory) == 40
    assert not tt._pending and not jt._pending


def test_poses_agree(runs):
    _, _, jt, tt = runs
    _pose_close(tt.trajectory, jt.trajectory)
    n = int(jt.map.n_kf)
    assert int(tt.map.n_kf) == n
    np.testing.assert_array_equal(tt.map.kf_valid.numpy(), np.asarray(jt.map.kf_valid))
    _pose_close([(0, R, t) for R, t in zip(tt.map.kf_R.numpy()[:n], tt.map.kf_t.numpy()[:n])],
                [(0, R, t) for R, t in zip(np.asarray(jt.map.kf_R)[:n],
                                            np.asarray(jt.map.kf_t)[:n])])


def test_loss_in_burst_drains_to_sync(sequence, fast_reference_brief):
    """The camera blinded for frames 12-17 inside a burst: both trackers
    count the same failures, drop what was in flight, return to the
    synchronous path and agree on every state and pose."""
    frames, rig, _ = sequence
    rng = np.random.default_rng(0)
    feed = []
    for i, (img, _, stamp) in enumerate(frames[:24]):
        if 12 <= i < 18:
            img = rng.uniform(0, 255, img.shape).astype(np.float32)
        feed.append((img, stamp))
    jt, tt = _trackers(rig)
    rec_j, rec_t = _drive(jt, feed), _drive(tt, feed)
    assert rec_t == rec_j
    assert tt.stats["track_fail"] >= 1
    assert tt.state in (ttr.OK, ttr.RECENTLY_LOST)
    assert not tt._pending and not tt._img_buf
    _pose_close(tt.trajectory, jt.trajectory)


def _frame_body_args(cfg):
    return dict(bf=float(cfg.bf), min_z=float(cfg.stereo.min_z),
                close_depth=float(cfg.stereo.depth_factor * cfg.stereo.baseline),
                r_coarse=float(cfg.tracker.match_radius_coarse),
                r_fine=float(cfg.tracker.match_radius_fine), cam_model=cfg.camera.model_id,
                img_w=cfg.camera.width, img_h=cfg.camera.height, n_levels=cfg.orb.n_levels,
                pose_rounds=cfg.tracker.pose_rounds, pose_iters=cfg.tracker.pose_iters,
                max_kp=cfg.orb.max_kp, fisheye=False, sad_refine=bool(cfg.stereo.sad_refine),
                local_only=True)


def test_frame_body_alone(runs, sequence):
    """`_frame_body` of both packages on the JAX run's final map, frames 20
    and 21, from a re-seeded chain at frame 19's pose and the velocity
    from frame 18 to 19; the second frame from the first's carry."""
    _, _, jt, _ = runs
    frames, rig, _ = sequence
    arrays = {k: np.asarray(v) for k, v in jt.map._asdict().items()}
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tm = tms.from_numpy(arrays)
    (_, R18, t18), (_, R19, t19) = jt.trajectory[18], jt.trajectory[19]
    R18, t18, R19, t19 = (np.asarray(x, np.float32) for x in (R18, t18, R19, t19))
    Rv = (R19 @ R18.T).astype(np.float32)
    tv = (t19 - Rv @ t18).astype(np.float32)
    F = 384
    chain = (R19, t19, Rv, tv, np.full(F, -1, np.int32), np.zeros(F, np.float32))
    j_carry = tuple(jnp.asarray(x) for x in chain) + (jm.mp_visible, jm.mp_found)
    t_carry = tuple(torch.from_numpy(np.array(x)) for x in chain) + (tm.mp_visible, tm.mp_found)
    jcfg, tcfg = small_config(JCfg, rig), small_config(TCfg, rig)
    kw = _frame_body_args(tcfg)
    local = kw.pop("local_only")
    ref_kf = int(jt.last_kf_id)
    cam = np.asarray(jcfg.camera.params, np.float32)
    zeros3 = np.zeros(3, np.float32)
    for i in (20, 21):
        j_mask = jtr._local_map_mask(jm, j_carry[4], ref_kf=jnp.int32(ref_kf))
        t_mask = ttr._local_map_mask(tm, t_carry[4], ref_kf=ref_kf)
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
        j_carry, j_out = jtr._frame_body(
            jm, j_carry, jnp.asarray(frames[i][0]), jnp.float32(12.0), jnp.asarray(cam),
            jnp.asarray(cam), jnp.eye(3), jnp.asarray(zeros3), local_only=local,
            lm_mask=j_mask, **kw)
        t_carry, t_out = ttr._frame_body(
            tm, t_carry, torch.from_numpy(np.array(frames[i][0])), 12.0,
            torch.from_numpy(cam), None, local_only=local, lm_mask=t_mask, **kw)
        jp, tp = np.asarray(j_out[0]), t_out[0].numpy()
        assert tp.shape == (ttr.PACK_LEN,)
        np.testing.assert_array_equal(tp[:4], jp[:4])
        assert jp[1] >= 50                                  # the frame tracked
        np.testing.assert_allclose(tp[4:], jp[4:], rtol=0, atol=1e-5)
        # keyframe inputs (rtol, atol): xy, level, angle (1e-4 rad, as
        # test_torch_extractor.py), desc, valid, u_right and depth (1e-5
        # relative: a few ulps, depth = bf / disparity), mp_feat
        tols = ((0, 1e-5), (0, 0), (0, 1e-4), (0, 0), (0, 0), (1e-5, 0), (1e-5, 0), (0, 0))
        for a, b, (rtol, atol) in zip(t_out[1:], j_out[1:], tols):
            np.testing.assert_allclose(a.numpy().astype(np.float64),
                                       np.asarray(b).astype(np.float64), rtol=rtol, atol=atol)
        np.testing.assert_array_equal(t_carry[4].numpy(), np.asarray(j_carry[4]))
        for a, b in zip(t_carry[6:], j_carry[6:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert int((t_carry[4] >= 0).sum()) > 50                # bindings for the next chunk
