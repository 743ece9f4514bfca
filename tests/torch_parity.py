"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`):
seeded inputs made with numpy and handed to both the JAX reference and the
PyTorch port."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest


def reference_compare_blur_matrices():
    """The JAX reference's `orient_brief._compare_blur_matrices`, computed as
    B^T D B by two matmuls instead of its einsum. Same f32 values on all 64
    angle bins (held by test_torch_brief_table.py); the einsum takes over a
    minute per process, the matmuls a second."""
    from orbslam3lib_tpu.ops import orient_brief as job
    B = job._blur_matrix().astype(np.float64)
    D = job._compare_matrices().astype(np.float64)
    D = D.reshape(-1, job.BRIEF_PATCH, job.BRIEF_PATCH)
    out = np.zeros((D.shape[0], job.RAW_FLAT_PAD), np.float32)
    out[:, :job.RAW_FLAT] = (B.T @ D @ B).reshape(D.shape[0], -1)
    return out


@pytest.fixture(scope="module")
def fast_reference_brief():
    """Module-scoped: the reference extractor builds its BRIEF table through
    `reference_compare_blur_matrices` (values unchanged)."""
    from orbslam3lib_tpu.ops import orient_brief as job
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(job, "_compare_blur_matrices", reference_compare_blur_matrices)
        yield


SMALL_RIG = dict(fx=150.0, fy=150.0, cx=160.0, cy=100.0, width=320, height=200)


def orbit_frames(n_frames: int, rig_kw=None, seed: int = 0, period: float = 24.0):
    """bench.py's room-orbit sequence (world, trajectory, noise seed) at a
    reduced rig size, rendered with the port's numpy renderer (which renders
    the same frames as the reference's, test_torch_config.py); `period` 8 s
    revisits the start after 120 frames. Returns (uint8 (n, 2, H, W),
    timestamps, rig)."""
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, render_orbit_sequence
    rig = StereoRig(**(SMALL_RIG if rig_kw is None else rig_kw))
    return render_orbit_sequence(n_frames, rig, seed, period=period)


def slice_config(cfg_cls, rig, max_kp: int = 256, n_levels: int = 4):
    """The same small stereo tracking configuration for either package."""
    cfg = cfg_cls()
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    cfg.orb.max_kp = max_kp
    cfg.orb.n_levels = n_levels
    cfg.orb.target_features = 200
    cfg.tracker.min_init_features = 100
    cfg.tracker.pose_rounds = 2
    cfg.tracker.pose_iters = 2
    cfg.map.max_kf = 16
    cfg.map.max_mp = 2048
    return cfg


def loop_config(cfg_cls, rig):
    """`slice_config` with room for a whole revolution of the small orbit
    (64 KF / 4096 MP) and the back end's window cut to the small map (BA
    window 3 + 2, 1024 points): the reference closes its loop there."""
    cfg = slice_config(cfg_cls, rig)
    cfg.map.max_kf = 64
    cfg.map.max_mp = 4096
    cfg.ba.window_size = 3
    cfg.ba.n_fixed = 2
    cfg.ba.max_points = 1024
    return cfg


def backend_config(cfg_cls, rig):
    """`slice_config` with the back end's window cut to the small map and
    dense keyframing (as tests/test_covis_mapping.py does): a keyframe every
    2 frames, so that about 16 frames run local BA, triangulation against
    several neighbours and culling."""
    cfg = slice_config(cfg_cls, rig)
    cfg.tracker.min_frames_between_kf = 2
    cfg.tracker.kf_ref_ratio = 10.0
    cfg.ba.window_size = 3
    cfg.ba.n_fixed = 2
    cfg.ba.max_points = 1024
    return cfg


def reference_backend_snapshots(n_frames: int):
    """Run the JAX tracker with its back end over the first n_frames of the
    small orbit and keep the map as it stood before each keyframe's
    `_mapping_pipeline`: {kf_id: numpy map}. Returns (snapshots, cfg)."""
    from orbslam3lib_tpu.config import SlamConfig
    from orbslam3lib_tpu.tracking import tracker as jtr
    imgs, ts, rig = orbit_frames(n_frames)
    cfg = backend_config(SlamConfig, rig)
    snaps = {}
    real = jtr.Tracker._mapping_pipeline

    def recording(self, kid, *a, **k):
        snaps[int(kid)] = {f: np.asarray(v) for f, v in self.map._asdict().items()}
        return real(self, kid, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr.Tracker, "_mapping_pipeline", recording)
        tr = jtr.Tracker(cfg, "stereo", enable_loop_closing=False, pipeline=0)
        for img, stamp in zip(imgs, ts):
            tr.process_frame(img, float(stamp))
    return snaps, cfg


@contextlib.contextmanager
def mapping_off():
    """Both Trackers without their per-keyframe back end
    (`_mapping_pipeline`): the tracking core alone."""
    from orbslam3lib_tpu.tracking import tracker as jtr
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jtr.Tracker, ttr.Tracker):
            mp.setattr(cls, "_mapping_pipeline", lambda self, *a, **k: None)
        yield


def reference_draws(valid, n_hyp: int, size: int, seed: int = 0) -> np.ndarray:
    """The indices the reference's RANSACs draw for a validity mask
    (`jax.random.choice` with its key and weights, sim3.py:59-62,
    reloc.py:67-71)."""
    import jax
    import jax.numpy as jnp
    p = jnp.asarray(np.asarray(valid), jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), p.shape[0],
                                        shape=(n_hyp, size), p=p))


@contextlib.contextmanager
def ransac_draws(draw):
    """The port's RANSACs (`pnp_ransac`, `sim3_ransac`,
    `reconstruct_two_views`) take their hypotheses from
    `draw(valid_numpy, n_hyp, size, seed)` (numpy indices) in place of their
    sampler, on any device."""
    import torch
    from orbslam3lib_tpu_torch.mapping import sim3 as tsim, twoview as ttv
    from orbslam3lib_tpu_torch.tracking import reloc as treloc

    def draws(valid, n_hyp, size, seed=0, hyp_idx=None):
        if hyp_idx is None:
            hyp_idx = draw(valid.cpu().numpy(), n_hyp, size, seed)
        return torch.as_tensor(np.asarray(hyp_idx), device=valid.device).long()

    with pytest.MonkeyPatch.context() as mp:
        for mod in (tsim, treloc, ttv):
            mp.setattr(mod, "ransac_indices", draws)
        yield


def reference_ransac_draws():
    """Whole runs of both packages see the same RANSAC samples: the port
    draws the reference's (`reference_draws`; the reference's two-view
    RANSAC draws with the same `jax.random.choice` call, twoview.py:120)."""
    return ransac_draws(reference_draws)


def host_ransac_draws():
    """The port's RANSACs draw on the CPU: the same hypotheses on the card
    as on the CPU (the two devices' generators give different streams for
    one seed). No JAX."""
    import torch
    from orbslam3lib_tpu_torch.utils.sampling import ransac_indices
    return ransac_draws(lambda v, n, k, seed: ransac_indices(torch.from_numpy(v), n, k, seed))


@contextlib.contextmanager
def reference_median_fault():
    """The port's initial monocular map keeps the two-view scale, as the
    reference's does (`scene_median_depth` reads 1, the reference's
    `jnp.nan_to_num(jnp.median(...), nan=1.0)` on its NaN median;
    tracker.py:406-408, ROADMAP queue 3)."""
    import torch
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "scene_median_depth",
                   lambda p3d, tri_ok: torch.ones((), device=p3d.device))
        yield


@contextlib.contextmanager
def reference_median_depth():
    """The port's repair of that fault put into the reference: its initial
    monocular map scaled to median depth 1 (the lower median of the
    triangulated depths, as the port's `_mono_init_map` and ORB-SLAM3's
    ComputeSceneMedianDepth(2)), as `tools/reference_smoke.py
    --median-depth` runs it. For monocular-inertial runs: the reference's
    own map keeps the two-view baseline as its unit, so a baseline under
    10 cm puts even an exact scale under the s < 0.1 guard of its IMU
    initialisation (tracker.py:2293)."""
    from orbslam3lib_tpu.tracking import tracker as jtr
    real = jtr._mono_init_map

    def scaled(m, *a, **k):
        tri_ok, t21, p3d = np.asarray(a[13]), a[15], a[16]
        z = np.asarray(p3d)[:, 2][tri_ok]
        med = float(np.sort(z)[(len(z) - 1) // 2]) if len(z) else 1.0
        a = list(a)
        a[15], a[16] = t21 / med, p3d / med
        return real(m, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "_mono_init_map", scaled)
        yield


@contextlib.contextmanager
def reference_single_device_gba():
    """The reference's post-loop global BA on its single-device route
    (`global_bundle_adjust`): under tests/conftest.py's virtual 8-device
    mesh its `global_bundle_adjust_auto` would take the sharded one."""
    from orbslam3lib_tpu.mapping import map_ba as jmb
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmb, "global_bundle_adjust_auto", jmb.global_bundle_adjust)
        yield


@contextlib.contextmanager
def reference_unscaled_points():
    """The port's loop correction leaves each landmark's depth in its
    keyframe as it was, as the reference's `apply_pose_graph_result`
    (loop_closing.py:437-453) does: the port divides it by the corrected
    Sim(3)'s scale when the closer's scale is free (ROADMAP queue 3)."""
    from orbslam3lib_tpu_torch.mapping import loop_closing as tlc
    real = tlc.apply_pose_graph_result
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlc, "apply_pose_graph_result",
                   lambda *a, scale_points=False: real(*a, scale_points=False))
        yield


@contextlib.contextmanager
def reference_small_angle():
    """The port's Lie maps with the reference's small-angle arithmetic
    (`orbslam3lib_tpu/utils/lie.py:23, 45-53`): the series only below
    theta^2 = 1e-8 and `_sim3_W`'s coefficients in f32. The port takes the
    series up to theta^2 = `lie._SERIES_THETA2` and `_sim3_W` in f64, since
    the f32 closed forms' derivatives are rounding noise for theta in
    ~[1e-4, 1e-1] (ROADMAP queue 3; tools/lie_small_angle.py). For tests
    that hold the two packages frame by frame or solve by solve."""
    from orbslam3lib_tpu_torch.utils import lie as tlie
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlie, "_SERIES_THETA2", tlie._EPS)
        mp.setattr(tlie, "_SIM3_W_DTYPE", None)
        yield


@pytest.fixture(autouse=True, scope="module")
def reference_lie():
    """`reference_small_angle` for a whole test module: import it into a
    module whose tests hold the two packages frame by frame or solve by
    solve."""
    with reference_small_angle():
        yield


def rotation_angle(Ra, Rb) -> np.ndarray:
    """The angle (rad) between rotations (..., 3, 3), from the skew part of
    Ra^T Rb in f64: arcsin |vee((D - D^T) / 2)|. Not arccos of the trace,
    whose f32 rounding near 3 reads 0, 4.9e-4 and 6.9e-4 rad in steps of
    one ulp (a rotation against itself can read 6.9e-4)."""
    D = np.einsum("...ji,...jk->...ik", np.asarray(Ra, np.float64), np.asarray(Rb, np.float64))
    S = 0.5 * (D - np.swapaxes(D, -1, -2))
    v = np.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], axis=-1)
    return np.arcsin(np.clip(np.linalg.norm(v, axis=-1), 0.0, 1.0))


@contextlib.contextmanager
def reference_rectify_edge():
    """The port's remaps with the reference's edge arithmetic
    (`orbslam3lib_tpu/utils/rectify.py:199-201`): the upper tap's weight
    from the unclipped floor, so a sample on the last row or column reads
    its neighbour at full weight. The port takes it from the clipped lower
    index (ROADMAP queue 3)."""
    from orbslam3lib_tpu_torch.utils import rectify as trect
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trect, "_fraction", lambda coord, floor, lower: coord - floor)
        yield


@contextlib.contextmanager
def reference_dist_edges():
    """The port's sharded BA with the reference's edge weights
    (`orbslam3lib_tpu/parallel/dist_ba.py:171`): an edge of an invalid
    landmark or camera weighs in too. The port weighs only those of valid
    ones, as both packages' plain `bundle_adjust` (ROADMAP queue 3)."""
    from orbslam3lib_tpu_torch.parallel import dist_ba as tdist
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdist, "_weighed_edges", lambda e_valid, e_own, cam_ok, pt_ok: e_valid & e_own)
        yield


@pytest.fixture(autouse=True, scope="module")
def reference_rectify():
    """`reference_rectify_edge` for a whole test module (the remap parity
    tests)."""
    with reference_rectify_edge():
        yield


class InlineFetches:
    """Stands in for the JAX tracker's background fetch pool (`_fetch_pool`,
    tracker.py:595): each fetch runs when it is submitted, so a chunk's
    packs are on the host by the next finalize, as on the port's CPU path,
    and which chunks a batch consumes no longer depends on a thread's
    timing. Install with `tracker._fetch_pool = InlineFetches()`."""

    def submit(self, fn, *args):
        import concurrent.futures
        fut = concurrent.futures.Future()
        fut.set_result(fn(*args))
        return fut


RING_CAM = np.array([300.0, 300.0, 320.0, 200.0], np.float32)


def _ring_kf_pose(theta, radius=2.0):
    c = np.array([radius * np.cos(theta), 0.0, radius * np.sin(theta)], np.float32)
    fwd = np.array([np.cos(theta), 0.0, np.sin(theta)], np.float32)
    right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1).astype(np.float32).T
    return R, -R @ c


def ring_world(seed: int = 71, n_kf: int = 12, drift_per_kf: float = 0.012,
               n_feat: int = 160, n_pts: int = 360):
    """tests/test_loop_closing.py's drifted ring world as numpy map arrays,
    built with numpy and the port's map model only (no JAX, so the card's
    tests use it too): landmarks on a cylinder wall, keyframes on a circle
    looking outward with accumulated drift, the last keyframe back at the
    start with its own (duplicate) landmarks anchored in its drifted frame;
    scale bands from the first keyframe's viewing distances, so
    SearchBySim3 can predict levels. Unlike the reference's test, every
    feature carries its true stereo depth, as the stereo slice's maps do:
    without it the global BA after a correction has a free scale direction
    (one fixed camera, mono edges) and amplifies f32 rounding to
    millimetres. Returns (map arrays, true poses, descriptors)."""
    import torch
    from orbslam3lib_tpu_torch.models import map_state as tms
    from orbslam3lib_tpu_torch.utils import lie as tl
    F, cam = n_feat, RING_CAM
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n_pts, endpoint=False)
    pts = np.stack([6.0 * np.cos(ang), rng.uniform(-1.5, 1.5, n_pts),
                    6.0 * np.sin(ang)], axis=1).astype(np.float32)
    descs = rng.integers(0, 2, size=(n_pts, 256)).astype(np.int8)
    m = tms.empty_map(max_kf=32, max_mp=1024, n_feat=F)
    thetas = np.concatenate([np.linspace(0, 2 * np.pi, n_kf, endpoint=False), [0.02]])
    true, est = [], []
    drift = np.zeros(6, np.float32)
    for i, th in enumerate(thetas):
        R, t = _ring_kf_pose(th)
        true.append((R, t))
        if i > 0:
            drift += (rng.normal(size=6) * drift_per_kf).astype(np.float32) * \
                np.array([1, 1, 1, 0.3, 0.3, 0.3], np.float32)
        dR, dt = tl.se3_exp(torch.from_numpy(drift))
        Re, te = tl.se3_compose(dR, dt, torch.from_numpy(R), torch.from_numpy(t))
        est.append((Re.numpy(), te.numpy()))
    first = np.full(n_pts, -1, np.int32)
    dup = {}
    last = len(thetas) - 1
    for i in range(len(thetas)):
        R, t = true[i]
        p_c = pts @ R.T + t
        uv = np.stack([cam[0] * p_c[:, 0] / p_c[:, 2] + cam[2],
                       cam[1] * p_c[:, 1] / p_c[:, 2] + cam[3]], axis=1)
        ok = (p_c[:, 2] > 1.0) & (uv[:, 0] > 5) & (uv[:, 0] < 635) & \
             (uv[:, 1] > 5) & (uv[:, 1] < 395)
        sel = np.nonzero(ok)[0][:F]
        n = len(sel)
        xy = np.zeros((F, 2), np.float32)
        desc = np.zeros((F, 256), np.int8)
        fv = np.zeros(F, bool)
        assoc = np.full(F, -1, np.int32)
        depth = np.zeros(F, np.float32)
        xy[:n], desc[:n], fv[:n], depth[:n] = uv[sel], descs[sel], True, p_c[sel, 2]
        if i < last:
            assoc[:n] = sel
            first[sel[first[sel] < 0]] = i
        else:
            ids = 500 + np.arange(n, dtype=np.int32)
            assoc[:n] = ids
            dup = dict(zip(ids.tolist(), sel.tolist()))
        tms.insert_keyframe(m, torch.from_numpy(est[i][0]), torch.from_numpy(est[i][1]),
                            float(i), torch.from_numpy(xy), torch.zeros(F, dtype=torch.int32),
                            torch.from_numpy(desc), torch.from_numpy(fv),
                            torch.from_numpy(assoc), torch.from_numpy(depth))
    arr = tms.to_numpy(m)
    for p, k in [(p, first[p]) for p in range(n_pts) if first[p] >= 0] + \
            [(d, last) for d in dup]:
        src = dup.get(p, p) if k == last else p
        (Rt_, tt_), (Re, te) = true[k], est[k]
        arr["mp_pos"][p] = Re.T @ (Rt_ @ pts[src] + tt_ - te)
        arr["mp_valid"][p], arr["mp_desc"][p], arr["mp_first_kf"][p] = True, descs[src], k
    arr["n_mp"] = np.int32(arr["mp_valid"].sum())
    c0 = -est[0][0].T @ est[0][1]
    dist = np.linalg.norm(arr["mp_pos"] - c0, axis=1) + 1e-3
    arr["mp_max_dist"] = dist.astype(np.float32)
    arr["mp_min_dist"] = (dist / 5.0).astype(np.float32)
    return arr, true, descs


def _merge_ring_kf_pose(theta, radius=2.0):
    c = np.array([radius * np.cos(theta), 0.0, radius * np.sin(theta)], np.float32)
    fwd = np.array([np.cos(theta), 0.0, np.sin(theta)], np.float32)
    right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1).astype(np.float32).T
    return R, -R @ c


def merge_ring_maps(thetas_a=(0.0, 0.4, 0.8, 1.2, 1.6),
                    thetas_b=(2.4, 2.8, 3.2, 0.05), G=None, seed: int = 42,
                    n_feat: int = 160, n_pts: int = 360):
    """tests/test_map_merge.py's two ring maps as numpy map arrays, built
    with numpy and the port's map model only (no JAX, so the card's tests
    use them too): landmarks on a cylinder wall, map A's keyframes at
    `thetas_a` in the true world, map B's at `thetas_b` in the world
    G = (R_g, t_g, s): x_B = s R_g x + t_g (default: a 0.3 rad yaw, a
    translation and scale 1.25); B's last keyframe revisits A's area.
    Returns (map A arrays, map B arrays, G, points, descriptors)."""
    import torch
    from orbslam3lib_tpu_torch.models import map_state as tms
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n_pts, endpoint=False)
    pts = np.stack([6.0 * np.cos(ang), rng.uniform(-1.5, 1.5, n_pts),
                    6.0 * np.sin(ang)], axis=1).astype(np.float32)
    descs = rng.integers(0, 2, size=(n_pts, 256)).astype(np.int8)
    if G is None:
        c, s_ = np.cos(0.3), np.sin(0.3)
        G = (np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32),
             np.array([0.5, 0.2, -0.3], np.float32), 1.25)
    cam = RING_CAM

    def build(thetas, G_):
        R_g, t_g, s = G_
        F = n_feat
        m = tms.empty_map(max_kf=32, max_mp=1024, n_feat=F)
        first = np.full(n_pts, -1, np.int32)
        for i, th in enumerate(thetas):
            R, t = _merge_ring_kf_pose(th)
            p_c = pts @ R.T + t
            uv = np.stack([cam[0] * p_c[:, 0] / p_c[:, 2] + cam[2],
                           cam[1] * p_c[:, 1] / p_c[:, 2] + cam[3]], axis=1)
            ok = (p_c[:, 2] > 1.0) & (uv[:, 0] > 5) & (uv[:, 0] < 635) & \
                 (uv[:, 1] > 5) & (uv[:, 1] < 395)
            sel = np.nonzero(ok)[0][:F]
            n = len(sel)
            xy = np.zeros((F, 2), np.float32)
            desc = np.zeros((F, 256), np.int8)
            fv = np.zeros(F, bool)
            assoc = np.full(F, -1, np.int32)
            xy[:n], desc[:n], fv[:n], assoc[:n] = uv[sel], descs[sel], True, sel
            first[sel[first[sel] < 0]] = i
            R_m = (R @ R_g.T).astype(np.float32)
            t_m = (s * t - R_m @ t_g).astype(np.float32)
            tms.insert_keyframe(m, torch.from_numpy(R_m), torch.from_numpy(t_m), float(i),
                                torch.from_numpy(xy), torch.zeros(F, dtype=torch.int32),
                                torch.from_numpy(desc), torch.from_numpy(fv),
                                torch.from_numpy(assoc), torch.zeros(F))
        arr = tms.to_numpy(m)
        obs = first >= 0
        arr["mp_pos"][:n_pts][obs] = pts[obs] @ R_g.T * s + t_g
        arr["mp_valid"][:n_pts] = obs
        arr["mp_desc"][:n_pts][obs] = descs[obs]
        arr["mp_first_kf"][:n_pts][obs] = first[obs]
        arr["n_mp"] = np.int32(n_pts)
        return arr

    ident = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0)
    return build(thetas_a, ident), build(thetas_b, G), G, pts, descs


def vi_window(C: int = 6, seed: int = 17, F: int = 128, n_pts: int = 256, gap: float = 0.1):
    """tests/test_vi_ba.py's window built with numpy and the port only (no
    JAX): C keyframes on the corridor from t = 1 s, `gap` s apart, poses
    after the first perturbed by 0.03, exact landmarks in front of them and
    each keyframe's observations; the gaps' preintegrations of the noisy
    corridor IMU (cfg.imu's noise). Returns (map arrays, the port's stacked
    preintegrations)."""
    import torch
    from orbslam3lib_tpu_torch.io.synthetic import corridor_pose_at, synth_imu
    from orbslam3lib_tpu_torch.models import map_state as tms
    from orbslam3lib_tpu_torch.tracking import imu as timu
    from orbslam3lib_tpu_torch.utils import lie as tl
    rng = np.random.default_rng(seed)
    cam = np.array([300.0, 300.0, 320.0, 200.0], np.float32)
    ts = [1.0 + i * gap for i in range(C)]
    R_cw, centers = corridor_pose_at(np.asarray(ts))
    pts = (centers.mean(0) + rng.uniform([-3, -2, -3], [3, 2, 3], size=(n_pts, 3))
           + np.array([0, 0, 6.0])).astype(np.float32)
    descs = rng.integers(0, 2, size=(n_pts, 256)).astype(np.int8)
    m = tms.empty_map(max_kf=16, max_mp=512, n_feat=F)
    for i in range(C):
        R = R_cw[i].T.astype(np.float32)
        t = (-R @ centers[i]).astype(np.float32)
        p_c = pts @ R.T + t
        uv = cam[:2] * p_c[:, :2] / p_c[:, 2:] + cam[2:]
        ok = (p_c[:, 2] > 0.5) & (np.abs(uv[:, 0] - 320) < 315) & (np.abs(uv[:, 1] - 200) < 195)
        sel = np.nonzero(ok)[0][:F]
        n = len(sel)
        xy = np.zeros((F, 2), np.float32)
        desc = np.zeros((F, 256), np.int8)
        fv = np.zeros(F, bool)
        assoc = np.full(F, -1, np.int32)
        xy[:n], desc[:n], fv[:n], assoc[:n] = uv[sel], descs[sel], True, sel
        Rn, tn = torch.from_numpy(R), torch.from_numpy(t)
        if i > 0:
            dR, dt = tl.se3_exp(torch.from_numpy((rng.normal(size=6) * 0.03).astype(np.float32)))
            Rn, tn = tl.se3_compose(dR, dt, Rn, tn)
        tms.insert_keyframe(m, Rn, tn, float(ts[i]), torch.from_numpy(xy),
                            torch.zeros(F, dtype=torch.int32), torch.from_numpy(desc),
                            torch.from_numpy(fv), torch.from_numpy(assoc), torch.zeros(F))
    arr = tms.to_numpy(m)
    arr["mp_pos"][:n_pts] = pts
    arr["mp_valid"][:n_pts] = True
    arr["n_mp"] = np.int32(n_pts)
    pres = []
    for i in range(C - 1):
        g, a, d = synth_imu(ts[i], ts[i + 1], freq=200.0, sigma_g=2.4e-3, sigma_a=2.8e-2, rng=rng)
        pres.append(timu.integrate(timu.empty_preintegrated(), g, a, d, 2.4e-3, 2.8e-2,
                                   1.9e-5, 3e-3))
    return arr, timu.Preintegrated.stack(pres)


# a EuRoC stereo rig rectified to pinhole: fx, fy, cx, cy
POSE_CAM = np.array([435.2, 435.2, 367.2, 252.2], np.float32)
POSE_BF = 435.2 * 0.11


def pose_problem(n: int, seed: int = 0):
    """One frame's motion-only pose solve in numpy: `n` observation rows of
    points 1-20 m in front of the true camera, matched with 0.5 px of noise,
    a third of them stereo, and among them rows the solver has to survive:
    10% outliers (20-60 px off), 5% invalid, 3% behind the camera, and rows
    at z exactly 0, within 1e-9 and within 1e-6 of it. Returns (fields of
    a `PoseObs`, the true (R, t), a start perturbed by ~0.02 rad and 5 cm),
    float32."""
    from orbslam3lib_tpu_torch.utils import lie as tl
    import torch
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = (float(v) for v in POSE_CAM)
    w_true = rng.normal(size=6) * np.array([0.3, 0.3, 0.3, 0.1, 0.1, 0.1])
    R, t = (x.numpy().astype(np.float32) for x in tl.se3_exp(torch.tensor(w_true)))
    z = rng.uniform(1.0, 20.0, n)
    u = rng.uniform(0.0, 2 * cx, n)
    v = rng.uniform(0.0, 2 * cy, n)
    kind = rng.random(n)
    behind = (kind > 0.92) & (kind <= 0.95)
    z[behind] = -rng.uniform(0.01, 3.0, behind.sum())
    z[:3] = (0.0, 5e-10, -7e-7)                    # z = 0, |z| < 1e-9, |z| < 1e-6
    p_c = np.stack([(u - cx) / fx * np.abs(z), (v - cy) / fy * np.abs(z), z], -1)
    p_w = (p_c - t) @ R                            # R^T (p_c - t)
    zs = np.where(np.abs(z) < 1e-6, 1.0, z)
    uv = np.stack([u, v], -1) + rng.normal(0.0, 0.5, (n, 2))
    out = kind < 0.10
    uv[out] += rng.choice([-1.0, 1.0], (out.sum(), 2)) * rng.uniform(20.0, 60.0, (out.sum(), 2))
    is_stereo = (rng.random(n) < 0.35) & (z > 0.5)
    u_right = np.where(is_stereo, u - POSE_BF / zs + rng.normal(0.0, 0.5, n), 0.0)
    level = rng.integers(0, 8, n)
    obs = dict(p_world=p_w.astype(np.float32), uv=uv.astype(np.float32),
               inv_sigma2=(1.0 / 1.2 ** (2 * level)).astype(np.float32),
               u_right=u_right.astype(np.float32), is_stereo=is_stereo,
               valid=(kind < 0.95) | (kind > 0.97))
    dR, dt = tl.se3_exp(torch.tensor(rng.normal(size=6) * np.array([0.03] * 3 + [0.012] * 3),
                                     dtype=torch.float32))
    R0, t0 = tl.se3_compose(dR, dt, torch.from_numpy(R), torch.from_numpy(t))
    return obs, (R, t), (R0.numpy(), t0.numpy())
