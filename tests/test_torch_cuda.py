"""The port's CUDA kernels against their plain PyTorch versions; the slice
with its back end, the loop leg (probe, verification, correction, global
BA), relocalisation, the rectifying remap, the fisheye matcher, `System`
on a raw radtan and a KB8 rig, compaction and the pipelined tracker on the
card against the same on the CPU; a chunk's dispatch without a host sync;
the mapper and GBA threads on the card; the cross-map match, the map merge
and an atlas round trip on the card; kernel 1 at batch 1 and `System` with
the monocular and the RGB-D sensor on the card against the CPU; the
threaded `System`'s local BA write-backs against the benchmark's plain
write-back; the inertial solvers (and the per-frame solve replayed from a
CUDA graph), the windowed VI-BA, `System("imu_mono")` (through its guard's abort on the
corridor, and through a successful IMU initialisation on phase J's excited
corridor) and the inertial map merge on the card against the CPU; the
pose solve's two kernels and the VI window's two kernels against their
torch paths on the card (marker `cuda`; skipped without a card). Imports no JAX, so it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Both kernels are exact (f32 min/max/sub; integer popcounts): `torch.equal`.
"""
import numpy as np
import pytest
import torch

from orbslam3lib_tpu_torch.config import SlamConfig
from orbslam3lib_tpu_torch.ops import cuda_fast, cuda_matcher, matcher
from orbslam3lib_tpu_torch.ops.extractor import DETECT_MARGIN
from orbslam3lib_tpu_torch.ops.pyramid import REF_HEIGHTS, REF_WIDTHS
from orbslam3lib_tpu_torch.tracking.tracker import Tracker

from torch_parity import RING_CAM, backend_config, host_ransac_draws, orbit_frames, ring_world

PALLAS_CASES = [(400, 640, 21), (80, 128, 21), (100, 161, 21), (64, 128, 3)]
LEVEL_CASES = [(h, w, DETECT_MARGIN) for h, w in zip(REF_HEIGHTS, REF_WIDTHS)]


def _bits(rng, na, nb, masked):
    a = (rng.random((na, 256)) < 0.5).astype(np.int8)
    b = (rng.random((nb, 256)) < 0.5).astype(np.int8)
    av = rng.random(na) < 0.9 if masked else None
    bv = rng.random(nb) < 0.9 if masked else None
    return a, b, av, bv


# the stats that count evaluations by path: (by the kernels, by the torch ops)
EVAL_PATHS = (("pose_evals_fused", "pose_evals_torch"), ("vi_evals_fused", "vi_evals_torch"))


def assert_same_stats(card: dict, cpu: dict) -> None:
    """The same stats on the card and the CPU, but for which path made the
    pose solve's and the VI window's evaluations: as many on both, on the
    CPU all by the torch ops (on a pinhole card the kernels make them)."""
    paths = {k for pair in EVAL_PATHS for k in pair}

    def strip(st):
        return {k: v for k, v in st.items() if k not in paths}
    assert strip(card) == strip(cpu)
    for fused, plain in EVAL_PATHS:
        assert card[fused] + card[plain] == cpu[fused] + cpu[plain]
        assert cpu[fused] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,margin", PALLAS_CASES + LEVEL_CASES)
def test_fast_kernel_matches_plain_on_card(cuda_device, h, w, margin):
    g = torch.Generator().manual_seed(h + w)
    img = torch.randint(0, 256, (2, h, w), generator=g, dtype=torch.uint8).to(cuda_device)
    before = cuda_fast.launches
    got = cuda_fast.fast_scores_nms(img, margin)
    torch.cuda.synchronize()
    assert cuda_fast.launches == before + 1
    assert torch.equal(got, cuda_fast.fast_scores_nms_plain(img, margin))


# every reference level at once; widths that are not multiples of 4, a
# level smaller than a tile and one of a single pixel
LEVEL_LISTS = {"reference": LEVEL_CASES,
               "odd": [(127, 203, 3), (101, 161, 3), (37, 314, 3), (5, 7, 3), (1, 1, 3)]}


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(LEVEL_LISTS))
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_fast_levels_kernel_matches_plain_on_card(cuda_device, which, dtype):
    """All levels in one launch, each level bit-exact against the plain
    version, on integer and on fractional images."""
    cases = LEVEL_LISTS[which]
    g = torch.Generator().manual_seed(len(cases))
    margin = cases[0][2]
    levels = [(torch.rand((2, h, w), generator=g) * 255.0).to(dtype).to(cuda_device)
              for h, w, _ in cases]
    before = cuda_fast.launches
    got = cuda_fast.fast_scores_nms_levels(levels, margin)
    torch.cuda.synchronize()
    assert cuda_fast.launches == before + 1
    for out, lvl in zip(got, levels):
        assert out.shape == lvl.shape and out.is_contiguous()
        assert torch.equal(out, cuda_fast.fast_scores_nms_plain(lvl, margin))


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb,masked", [(64, 64, True), (300, 450, True),
                                          (512, 1024, True), (100, 200, False),
                                          (512, 512, True), (1, 1, True),
                                          (33, 3000, True), (3, 16500, True)])
def test_knn_kernel_matches_plain_on_card(cuda_device, na, nb, masked):
    a, b, av, bv = (None if x is None else torch.from_numpy(x).to(cuda_device)
                    for x in _bits(np.random.default_rng(na + nb), na, nb, masked))
    before = cuda_matcher.launches
    got = cuda_matcher.knn_match_fused(a, b, av, bv)
    torch.cuda.synchronize()
    assert cuda_matcher.launches == before + 1
    for g, w in zip(got, matcher.knn_match(a, b, av, bv)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_knn_kernel_on_unaligned_rows(cuda_device):
    """Bits whose base is not 16-byte aligned take the kernel's byte loads."""
    a, b, av, bv = (torch.from_numpy(x).to(cuda_device)
                    for x in _bits(np.random.default_rng(7), 70, 600, True))
    a_off = torch.empty(70 * 256 + 3, dtype=torch.int8, device=cuda_device)[3:].view(70, 256)
    a_off.copy_(a)
    assert a_off.data_ptr() % 16 != 0
    got = cuda_matcher.knn_match_fused(a_off, b, av, bv)
    for g, w in zip(got, matcher.knn_match(a, b, av, bv)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_slice_with_back_end_on_card_matches_cpu(cuda_device):
    """16 frames of the small orbit with local mapping and local BA on
    every keyframe (test_torch_slam.py's configuration), on the card and on
    the CPU: the same counts and keyframe records, kf_mp >= 98% equal and
    n_mp within 2% (f32 sums in another order may flip a marginal match),
    camera centres within 5 mm. The back end's duplicate-index scatters pick
    their write explicitly, so the card's scatter order cannot change it."""
    imgs, ts, rig = orbit_frames(16)
    trackers = [Tracker(backend_config(SlamConfig, rig), "stereo", device=d,
                        enable_loop_closing=False)
                for d in ("cpu", cuda_device)]
    for img, stamp in zip(imgs, ts):
        for tr in trackers:
            tr.process_frame(img, float(stamp))
    cpu, card = trackers
    assert_same_stats(card.stats, cpu.stats)
    assert cpu.stats["n_local_ba"] >= 2
    assert card.stats["pose_evals_torch"] == 0 < card.stats["pose_evals_fused"]
    m_cpu, m_card = cpu.map, card.map
    assert torch.equal(m_card.kf_valid.cpu(), m_cpu.kf_valid)
    assert torch.equal(m_card.kf_parent.cpu(), m_cpu.kf_parent)
    assert (m_card.kf_mp.cpu() == m_cpu.kf_mp).float().mean() >= 0.98
    assert abs(int(m_card.n_mp) - int(m_cpu.n_mp)) <= 0.02 * int(m_cpu.n_mp)
    np.testing.assert_allclose(card.trajectory_centers(), cpu.trajectory_centers(),
                               rtol=0, atol=5e-3)


def _ring_on(dev, arrays=None):
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.models import vocabulary as vb
    from orbslam3lib_tpu_torch.tracking.reloc import PlaceRecognition
    world, _, descs = ring_world()
    voc = vb.train_vocabulary(descs, k=4, depth=3).to(dev)
    m = ms.from_numpy(world if arrays is None else arrays, device=dev)
    pr = PlaceRecognition(voc, m.max_kf)
    for i in range(13):
        pr.add(i, m.kf_desc[i], m.kf_feat_valid[i])
    return m, pr


def _ring_arrays(shrink: float, depth: bool):
    """The ring world, its revisit (keyframe 12 and its landmarks) shrunk
    about the revisit's camera by `shrink` (tests/test_torch_loop_scale.py's
    drift); without `depth`, no feature carries a stereo depth (a
    monocular map)."""
    arrays, _, _ = ring_world()
    R, t = arrays["kf_R"][12], arrays["kf_t"][12]
    c = -R.T @ t
    own = arrays["mp_valid"] & (arrays["mp_first_kf"] == 12)
    arrays["mp_pos"][own] = c + shrink * (arrays["mp_pos"][own] - c)
    arrays["kf_depth"][12] *= shrink
    if not depth:
        arrays["kf_depth"][:] = 0.0
    return arrays


# (revisit shrink, stereo depths, fixed scale): the stereo tracker's loop
# closer on the ring world as drawn (scale fixed), and the monocular
# tracker's (free scale, no depths) on it as drawn and with its revisit
# shrunk to 0.8. A free scale on a map with stereo depths is no sensor's
# setting: its pose-graph scales (0.987-1.0 on the ring world) move the
# landmarks off their keyframes' measured depths, and the global BA there
# carries a 1e-6 relative move of the landmarks to 1.3e-4 rad of keyframe
# rotation on the CPU alone (tools/card_divergence.py; PERF.md section 7).
LOOP_WORLDS = {"stereo": (1.0, True, True), "mono": (1.0, False, False),
               "mono_drifted": (0.8, False, False)}
# after the global BA, card against CPU: the stereo map's, and the
# monocular maps' (their landmarks fixed by triangulation alone, with the
# scale free, where the card's own runs spread: over 38 runs of the leg
# against one CPU run, up to 2.7e-5 rad, 2.4e-4 and 1.7e-3 m; this test's
# own runs up to 1.25e-4 rad; tools/card_divergence.py --loop-repeats,
# NVIDIA H100 80GB HBM3, 700 W)
GBA_TOL = {True: {"kf_R": 1e-4, "kf_t": 1e-4, "mp_pos": 1e-4},
           False: {"kf_R": 5e-4, "kf_t": 1e-3, "mp_pos": 5e-3}}


@pytest.mark.cuda
@pytest.mark.parametrize("world", sorted(LOOP_WORLDS))
def test_loop_verification_and_correction_on_card_match_cpu(cuda_device, world):
    """The ring world's loop (tests/test_torch_loop.py), probed, verified
    and corrected with the global BA on the card and on the CPU, the
    RANSACs on the same draws: the probe pack and the verification counts
    equal, the Sim3 within 1e-4, the corrected poses and landmarks within
    5e-5 before the global BA (observed 5.7e-6) and within `GBA_TOL`
    after it; kernel 2 ran on the card (probe and verification). Free
    scale: the Sim3's scale finds the revisit's (1 or 0.8) within 1e-3."""
    from orbslam3lib_tpu_torch.mapping import loop_closing as lc
    from orbslam3lib_tpu_torch.models import map_state as ms
    shrink, depth, fix_scale = LOOP_WORLDS[world]
    arrays = _ring_arrays(shrink, depth)
    fields = ("kf_R", "kf_t", "mp_pos")
    out = {}
    with host_ransac_draws(), pytest.MonkeyPatch.context() as mp:
        gba = lc.global_bundle_adjust
        corrected = []
        mp.setattr(lc, "global_bundle_adjust", lambda m, *a, **k: corrected.append(
            {f: getattr(m, f).cpu().numpy().copy() for f in fields}) or gba(m, *a, **k))
        for dev in ("cpu", cuda_device):
            m, pr = _ring_on(dev, arrays)
            cam = torch.from_numpy(RING_CAM).to(dev)
            voc = pr.voc
            before = cuda_matcher.launches
            probe = lc.loop_probe(m, pr.bow_db, pr.active, voc.centroids, voc.idf, 12,
                                  k=voc.k, depth=voc.depth, prev_cand=-1).cpu().numpy()
            closer = lc.LoopCloser(SlamConfig(), pr, consistency_needed=1,
                                   fix_scale=fix_scale)
            m = closer.on_probe_result(m, 12, probe, cam)
            out[str(dev)] = (probe, closer, m, cuda_matcher.launches - before)
    (p_c, c_c, m_c, _), (p_g, c_g, m_g, n_launch) = out["cpu"], out[str(cuda_device)]
    assert n_launch >= 2
    np.testing.assert_array_equal(p_g[[0, 1, 2, 6, 7, 8, 10]], p_c[[0, 1, 2, 6, 7, 8, 10]])
    np.testing.assert_allclose(p_g, p_c, rtol=0, atol=1e-6)
    assert c_g.n_loops == c_c.n_loops == 1 and len(corrected) == 2
    pg, pc = c_g.last_verification[2], c_c.last_verification[2]
    np.testing.assert_array_equal(pg[:5], pc[:5])
    np.testing.assert_allclose(pg[5:], pc[5:], rtol=0, atol=1e-4)
    if not fix_scale:
        assert abs(pc[17] - shrink) < 1e-3
    for f in fields:
        np.testing.assert_allclose(corrected[1][f], corrected[0][f], rtol=0, atol=5e-5,
                                   err_msg=f"{f} before the global BA")
        np.testing.assert_allclose(getattr(m_g, f).cpu().numpy(), getattr(m_c, f).numpy(),
                                   rtol=0, atol=GBA_TOL[depth][f], err_msg=f)


@pytest.mark.cuda
def test_relocalisation_on_card_matches_cpu(cuda_device):
    """The ring world's revisiting keyframe as a lost frame: the database's
    candidates, and relocalisation against the first keyframe, on the card
    and on the CPU with the same RANSAC draws: candidates and inlier counts
    equal, poses within 1e-4."""
    from orbslam3lib_tpu_torch.models import vocabulary as vb
    from orbslam3lib_tpu_torch.tracking import reloc
    out = {}
    with host_ransac_draws():
        for dev in ("cpu", cuda_device):
            m, pr = _ring_on(dev)
            cam = torch.from_numpy(RING_CAM).to(dev)
            frame = (m.kf_xy[12], m.kf_level[12], m.kf_desc[12], m.kf_feat_valid[12],
                     m.kf_angle[12])
            q = vb.bow_from_descriptors(pr.voc, frame[2], frame[3])
            ids, _ = reloc.detect_reloc_candidates(m, pr.bow_db, pr.active, q)
            R, t, n = reloc.relocalize_against_kf(m, 0, *frame, cam)
            out[str(dev)] = (ids.cpu(), R.cpu(), t.cpu(), int(n))
    (ids_c, R_c, t_c, n_c), (ids_g, R_g, t_g, n_g) = out["cpu"], out[str(cuda_device)]
    assert torch.equal(ids_g, ids_c)
    assert n_g == n_c >= 50
    np.testing.assert_allclose(R_g.numpy(), R_c.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_g.numpy(), t_c.numpy(), rtol=0, atol=1e-4)


DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
SMALL = dict(fx=150.0, fy=150.0, cx=160.0, cy=100.0, width=320, height=200)
SMALL_KB8 = dict(fx=142.5, fy=142.5, cx=160.0, cy=100.0, width=320, height=200,
                 model="kannala_brandt8", k=(0.02, -0.01, 0.003, 0.0))


@pytest.mark.cuda
def test_remap_on_card_matches_cpu(cuda_device):
    """The rectifying remap of a rendered raw pair: the same gathers and
    fused sums on the card as on the CPU (to 1e-3 grey levels), and no
    value read back to the host (sync debug mode "error")."""
    from orbslam3lib_tpu_torch.utils import cameras, rectify
    imgs, _, rig = orbit_frames(2, dict(SMALL, dist=DIST))
    rr = rectify.stereo_rectify(rig.params, rig.params, cameras.PINHOLE_RADTAN,
                                cameras.PINHOLE_RADTAN, np.eye(3),
                                np.array([rig.baseline, 0, 0]), rig.width, rig.height)
    mp2 = rectify.twopass_maps(rr.maps)
    cpu = rectify.TwoPassRemap(mp2)(torch.from_numpy(imgs[1]))
    remap = rectify.TwoPassRemap(mp2, cuda_device)
    x = torch.from_numpy(imgs[1]).to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = remap(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_fisheye_matcher_on_card_matches_cpu(cuda_device):
    """match_fisheye_stereo on KB8 projections of random points: the same
    accepted pairs, depth to 1e-4 m and u_r to the px that follow from it."""
    from orbslam3lib_tpu_torch.tracking.matching import match_fisheye_stereo
    from orbslam3lib_tpu_torch.utils import cameras
    rng = np.random.default_rng(5)
    K = torch.tensor([285.0, 285.0, 320.0, 200.0, 0.02, -0.01, 0.003, 0.0])
    pts = torch.from_numpy(rng.uniform([-2, -1.5, 1.0], [2, 1.5, 4.5], (300, 3)).astype(np.float32))
    t = torch.tensor([0.11, 0.0, 0.0])
    uv_l, uv_r = cameras.kb8_project(K, pts), cameras.kb8_project(K, pts - t)
    desc = torch.from_numpy(rng.integers(0, 2, (300, 256)).astype(np.int8))
    perm = torch.from_numpy(rng.permutation(300))
    args = (uv_l, desc, torch.ones(300, dtype=torch.bool), uv_r[perm], desc[perm],
            torch.rand(300, generator=torch.Generator().manual_seed(1)) < 0.9,
            K, K, torch.eye(3), t)
    u_c, d_c = match_fisheye_stereo(*args, 285.0 * 0.11)
    u_g, d_g = match_fisheye_stereo(*(a.to(cuda_device) for a in args), 285.0 * 0.11)
    assert torch.equal(d_g.cpu() > 0, d_c > 0) and int((d_c > 0).sum()) > 150
    np.testing.assert_allclose(d_g.cpu().numpy(), d_c.numpy(), rtol=0, atol=1e-4)
    # u_r = u - bf / z moves by bf / z^2 * dz: up to 3.1e-3 px for dz = 1e-4 m
    # at z >= 1 m (the card's atan, tan and sqrt round otherwise)
    np.testing.assert_allclose(u_g.cpu().numpy(), u_c.numpy(), rtol=0, atol=5e-3)


def _system_config(rig_name, rig):
    from orbslam3lib_tpu_torch.config import CameraConfig
    cfg = backend_config(SlamConfig, rig)
    if rig_name == "radtan":
        cfg.camera.dist = DIST
        cfg.stereo.rectify = True
    else:
        cfg.camera = CameraConfig(model="kannala_brandt8", fx=rig.fx, fy=rig.fy,
                                  cx=rig.cx, cy=rig.cy, k=tuple(rig.k),
                                  width=rig.width, height=rig.height)
        cfg.stereo.fisheye = True
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("rig_name", ["radtan", "kb8"])
def test_system_on_card_matches_cpu(cuda_device, rig_name):
    """16 frames of the small orbit through `System.track_stereo` on a raw
    radtan rig (rectified on the card) and on the KB8 rig, on the card and
    on the CPU: the same counts, camera centres within 5 mm."""
    from orbslam3lib_tpu_torch.system import System
    imgs, ts, rig = orbit_frames(16, dict(SMALL, dist=DIST) if rig_name == "radtan"
                                 else SMALL_KB8)
    systems = [System(_system_config(rig_name, rig), device=d, enable_loop_closing=False)
               for d in ("cpu", cuda_device)]
    for img, stamp in zip(imgs, ts):
        for s in systems:
            s.track_stereo(img, float(stamp))
    cpu, card = systems
    assert_same_stats(card.get_stats(), cpu.get_stats())
    assert card.get_tracking_state() == cpu.get_tracking_state() == 1
    np.testing.assert_allclose(card.tracker.trajectory_centers(),
                               cpu.tracker.trajectory_centers(), rtol=0, atol=5e-3)


@pytest.mark.cuda
def test_pipeline_on_card_matches_sync(cuda_device):
    """`System(use_pipeline=True)` on the card: the consumer thread tracks on
    the tracker's card and hands `pose_callback` the poses of a synchronous
    System on the same frames (the same counts, centres within 1 mm); held
    off by the tracker's lock, two of the next six frames wait in the queue
    and three are dropped; `shutdown` joins the thread."""
    from orbslam3lib_tpu_torch.system import System
    imgs, ts, rig = orbit_frames(18)
    got = []

    def callback(R, t, stamp, out):
        got.append((stamp, -R.T @ t, torch.cuda.current_device()))

    sync = System(backend_config(SlamConfig, rig), device=cuda_device,
                  enable_loop_closing=False)
    pipe = System(backend_config(SlamConfig, rig), device=cuda_device,
                  enable_loop_closing=False, use_pipeline=True, pose_callback=callback)
    consumer = pipe._consumer
    for img, stamp in zip(imgs[:12], ts[:12]):
        sync.track_stereo(img, float(stamp))
        assert pipe.track_stereo(img, float(stamp)) == {"queued": True}
        pipe.wait_idle(timeout=120.0)
    assert pipe._dropped == 0 and [g[0] for g in got] == [float(s) for s in ts[:12]]
    assert pipe.get_stats() == sync.get_stats()
    assert {g[2] for g in got} == {pipe.tracker.device.index}
    np.testing.assert_allclose(np.stack([g[1] for g in got]),
                               sync.tracker.trajectory_centers(), rtol=0, atol=1e-3)
    with pipe._lock:
        pipe.track_stereo(imgs[12], float(ts[12]))
        while not pipe._queue.empty():
            pass
        for img, stamp in zip(imgs[13:], ts[13:]):
            pipe.track_stereo(img, float(stamp))
    pipe.wait_idle(timeout=120.0)
    pipe.shutdown()
    assert not consumer.is_alive() and pipe._consumer is None
    assert pipe._dropped == 3 and len(got) == 15
    assert pipe.get_stats()["n_frames"] == 15


@pytest.mark.cuda
def test_compaction_on_card_matches_cpu(cuda_device):
    """24 frames of the small orbit with 12 keyframe / 1,024 landmark slots
    and a keyframe per frame, on the card and on the CPU: the same
    compactions and counts, centres within 5 mm; and `compact_map` of the
    CPU's final map, with two keyframes culled, equal on both devices."""
    from orbslam3lib_tpu_torch.models import map_state as ms
    imgs, ts, rig = orbit_frames(24)
    trackers = []
    for d in ("cpu", cuda_device):
        cfg = backend_config(SlamConfig, rig)
        cfg.map.max_kf, cfg.map.max_mp = 12, 1024
        cfg.tracker.min_frames_between_kf = 1
        trackers.append(Tracker(cfg, "stereo", device=d))
    for img, stamp in zip(imgs, ts):
        for tr in trackers:
            tr.process_frame(img, float(stamp))
    cpu, card = trackers
    assert_same_stats(card.stats, cpu.stats)
    assert cpu.stats["n_compactions"] >= 1
    np.testing.assert_allclose(card.trajectory_centers(), cpu.trajectory_centers(),
                               rtol=0, atol=5e-3)
    arrays = ms.to_numpy(cpu.map)
    arrays["kf_valid"][[1, 3]] = False
    a = ms.compact_map(ms.from_numpy(arrays))
    b = ms.compact_map(ms.from_numpy(arrays, device=cuda_device))
    assert torch.equal(a[1], b[1].cpu()) and torch.equal(a[2], b[2].cpu())
    for name, x in ms.to_numpy(a[0]).items():
        np.testing.assert_array_equal(ms.to_numpy(b[0])[name], x, err_msg=name)


@pytest.mark.cuda
def test_pipelined_on_card_matches_cpu(cuda_device):
    """The pipelined tracker (`pipeline=6, chunk=2`, mapping inline) on 40
    frames of the small orbit with the back end, on the card and on the
    CPU: the same keyframes and failures, camera centres within 1 mm, and
    every frame in the trajectory. (It is not held to the synchronous
    tracker: a chunk's lag and its chain's restart without bindings make it
    another algorithm, 3.7 cm apart from the synchronous one on these
    frames on the CPU.)"""
    imgs, ts, rig = orbit_frames(40)
    trackers = [Tracker(backend_config(SlamConfig, rig), "stereo", device=d,
                        enable_loop_closing=False, pipeline=6, chunk=2)
                for d in ("cpu", cuda_device)]
    for img, stamp in zip(imgs, ts):
        for tr in trackers:
            tr.process_frame(img, float(stamp))
    for tr in trackers:
        tr.finish()
    cpu, card = trackers
    assert_same_stats(card.stats, cpu.stats)
    assert cpu.stats["n_kf"] >= 10
    assert len(card.trajectory) == len(imgs)
    np.testing.assert_allclose(card.trajectory_centers(), cpu.trajectory_centers(),
                               rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_dispatch_chunk_reads_nothing_back(cuda_device):
    """`_dispatch_chunk` under torch's sync debug mode "error": a chunk of
    two frames (extraction, stereo, the two-stage search and pose LM, the
    packs' copy into pinned memory) never waits for the card."""
    imgs, ts, rig = orbit_frames(8)
    tr = Tracker(backend_config(SlamConfig, rig), "stereo", device=cuda_device,
                 enable_loop_closing=False, pipeline=6, chunk=2)
    for img, stamp in zip(imgs[:5], ts[:5]):
        tr.process_frame(img, float(stamp))
    tr._drain_pipeline()
    assert tr.state == 1
    frames = [(torch.as_tensor(imgs[i], device=cuda_device), float(ts[i]), i) for i in (5, 6)]
    torch.cuda.synchronize()
    tr._img_buf = frames
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr._dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert len(tr._pending) == 1
    tr._drain_pipeline()
    assert len(tr.trajectory) == 7 and tr.state == 1


@pytest.mark.cuda
def test_mapper_and_gba_threads_on_card(cuda_device):
    """The mapper thread and the GBA thread run on the tracker's card (their
    current device, recorded from inside each) and are joined by
    `shutdown_mapping`; the GBA merges into the live map on the card."""
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    imgs, ts, rig = orbit_frames(24)
    cfg = backend_config(SlamConfig, rig)
    cfg.mapping.async_gba = True
    tr = Tracker(cfg, "stereo", device=cuda_device, enable_loop_closing=False,
                 async_mapping=True)
    seen = []
    real_map = tr._mapping_pipeline

    def mapping(kid, **kw):
        seen.append(("mapper", torch.cuda.current_device()))
        return real_map(kid, **kw)

    tr._mapping_pipeline = mapping
    real_gba = ttr.global_bundle_adjust_auto

    def gba(*a, **kw):
        seen.append(("gba", torch.cuda.current_device()))
        return real_gba(*a, **kw)

    ttr.global_bundle_adjust_auto = gba
    try:
        for img, stamp in zip(imgs, ts):
            tr.process_frame(img, float(stamp))
        tr.wait_mapping_idle()
        tr.loop_closer = ttr.LoopCloser(cfg, tr.place_rec, gba_iters=3)
        with tr._map_lock:
            tr._maybe_start_gba()
        mapper, gba_thread = tr._mapper_thread, tr._gba_thread
        tr.shutdown_mapping()
    finally:
        ttr.global_bundle_adjust_auto = real_gba
    idx = cuda_device.index or 0
    assert {w for w, _ in seen} == {"mapper", "gba"}
    assert all(d == idx for _, d in seen)
    assert not mapper.is_alive() and not gba_thread.is_alive()
    assert tr.stats["n_gba_merged"] == 1 and tr.stats["mapper_errors"] == 0
    assert tr.map.kf_R.device.type == "cuda"


@pytest.mark.cuda
def test_threaded_system_write_backs_on_card(cuda_device, monkeypatch):
    """The threaded deployment (`cfg.mapping.mapper_thread`, `async_gba`)
    through `System` on chip_smoke's orbit (640x400, 400 frames, its first
    loop near frame 343): every local BA the mapper solved off the map lock
    was written back as `slambench/reference/writeback.py` writes it, from
    the same live map and snapshot, bit for bit; nothing was dropped; the
    loop closed and its global BA ran on its thread; no mapper or GBA error;
    every thread joined."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from orbslam3lib_tpu_torch import system as tsys
    from orbslam3lib_tpu_torch.io.synthetic import (StereoRig, orbit_tracking_config,
                                                    render_orbit_sequence)
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    from slambench.reference import writeback
    imgs, ts, rig = render_orbit_sequence(400, StereoRig())
    cfg = orbit_tracking_config(rig)
    cfg.mapping.mapper_thread = cfg.mapping.async_gba = True
    folds = []
    real = ttr.fold_window_result

    def host(m, names):
        return {k: getattr(m, k).to("cpu", copy=True) for k in names}

    def fold(m_now, solved, window_ids, fixed_mask, n_ba_points):
        live, snap = host(m_now, writeback.LIVE_FIELDS), host(solved, writeback.SNAPSHOT_FIELDS)
        out = real(m_now, solved, window_ids, fixed_mask, n_ba_points)
        folds.append((live, snap, window_ids.cpu(), fixed_mask.cpu(), n_ba_points,
                      host(out, writeback.LIVE_FIELDS)))
        return out

    monkeypatch.setattr(ttr, "fold_window_result", fold)
    s = tsys.System(cfg, "stereo", device=cuda_device)
    mapper = s.tracker._mapper_thread
    assert mapper is not None and mapper.is_alive()
    threads = [mapper]
    for img, stamp in zip(imgs, ts):
        s.track_stereo(img, float(stamp))
        if s.tracker._gba_thread is not None and s.tracker._gba_thread not in threads:
            threads.append(s.tracker._gba_thread)
    s.shutdown()
    st, tr = s.get_stats(), s.tracker
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    assert tr._mapper_thread is None and tr._gba_thread is None
    assert st["mapper_errors"] == st["gba_errors"] == 0 and not tr.errors
    assert st["n_loops"] >= 1 and st["n_gba_started"] >= 1
    assert st["n_gba_merged"] + st["n_gba_aborted"] == st["n_gba_started"]
    assert st["local_ba_dropped"] == 0 and len(folds) == st["n_local_ba"] >= 10
    for live, snap, ids, fixed, n, got in folds:
        want = writeback.writeback(live, snap, ids, fixed, n)
        for k in writeback.LIVE_FIELDS:
            assert torch.equal(got[k], want[k]), k


def _merge_atlas_on(dev):
    """tests/test_torch_map_merge.py's ring maps in an Atlas on `dev`: map A
    archived with its BoW database, map B current."""
    from orbslam3lib_tpu_torch.mapping import loop_closing as lc
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.models import vocabulary as vb
    from orbslam3lib_tpu_torch.models.atlas import Atlas
    from orbslam3lib_tpu_torch.tracking.reloc import PlaceRecognition
    from torch_parity import merge_ring_maps
    a, b, _, _, descs = merge_ring_maps()
    voc = vb.train_vocabulary(descs, k=4, depth=3).to(dev)
    at = Atlas(32, 1024, 160, device=dev)
    at.maps = [ms.from_numpy(a, device=dev), ms.from_numpy(b, device=dev)]
    at.bad, at.current = [False, False], 1
    db = PlaceRecognition(voc, 32)
    for i in range(int(at.maps[0].n_kf)):
        db.add(i, at.maps[0].kf_desc[i], at.maps[0].kf_feat_valid[i])
    cfg = SlamConfig()
    cfg.camera.fx = cfg.camera.fy = 300.0
    cfg.camera.cx, cfg.camera.cy = 320.0, 200.0
    merger = lc.MapMerger(cfg, consistency_needed=1)
    merger.archive(0, db)
    return at, merger


@pytest.mark.cuda
def test_cross_match_on_card_matches_cpu(cuda_device):
    """`match_kf_landmarks_cross` on the ring maps: kernel 2 on the card
    against its plain version on the CPU; indices and masks equal, the
    camera-frame points within 1e-5 m."""
    from orbslam3lib_tpu_torch.mapping import loop_closing as lc
    out = {}
    for dev in ("cpu", cuda_device):
        at, _ = _merge_atlas_on(dev)
        before = cuda_matcher.launches
        res = lc.match_kf_landmarks_cross(at.maps[1], 3, at.maps[0], 0)
        out[str(dev)] = ([x.cpu() for x in res], cuda_matcher.launches - before)
    (c, _), (g, n_launch) = out["cpu"], out[str(cuda_device)]
    assert n_launch == 1
    assert torch.equal(g[4], c[4]) and int(c[4].sum()) > 40
    assert torch.equal(g[2], c[2]) and torch.equal(g[3][c[4]], c[3][c[4]])
    for k in (0, 1):
        np.testing.assert_allclose(g[k][c[4]].numpy(), c[k][c[4]].numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_map_merge_on_card_matches_cpu(cuda_device):
    """`MapMerger.on_keyframe` and `Atlas.merge` on the card against the
    CPU on the same RANSAC draws: the same decision, the merged map's
    integer and bool fields equal, poses and landmarks within 1e-3 (Sim3
    RANSAC, OptimizeSim3 and the welding BA in f32, summed in another
    order); kernel 2 ran inside the merge."""
    from orbslam3lib_tpu_torch.models import map_state as ms
    out = {}
    with host_ransac_draws():
        for dev in ("cpu", cuda_device):
            at, merger = _merge_atlas_on(dev)
            before = cuda_matcher.launches
            done = merger.on_keyframe(at, 3, torch.from_numpy(RING_CAM).to(dev))
            out[str(dev)] = (done, at, cuda_matcher.launches - before)
    (dc, ac, _), (dg, ag, n_launch) = out["cpu"], out[str(cuda_device)]
    assert dc and dg and n_launch >= 1
    assert ac.count_maps() == ag.count_maps() == 1
    for k in ms.FIELDS:
        x, y = getattr(ag.current_map, k).cpu(), getattr(ac.current_map, k)
        if x.dtype == torch.float32:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-3, err_msg=k)
        else:
            assert torch.equal(x, y), k


@pytest.mark.cuda
def test_atlas_round_trip_from_card(cuda_device, tmp_path):
    """An Atlas of card tensors saved and loaded back onto the card: every
    array equal, on the card, the current map the same."""
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.models import serialization as ser
    at, _ = _merge_atlas_on(cuda_device)
    path = str(tmp_path / "atlas.npz")
    ser.save_atlas(at, path)
    got = ser.load_atlas(path, device=cuda_device)
    assert (got.count_maps(), got.current, got._dims) == (2, 1, at._dims)
    for a, b in zip(got.maps, at.maps):
        for k in ms.FIELDS:
            assert getattr(a, k).device.type == "cuda"
            assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.cuda
def test_fast_levels_kernel_at_batch_one_on_card(cuda_device):
    """Kernel 1 on one rendered 640x400 image's 8 levels in one launch (the
    monocular and RGB-D frame), each level bit-exact."""
    from orbslam3lib_tpu_torch.io.synthetic import render_orbit_sequence
    from orbslam3lib_tpu_torch.ops import pyramid
    imgs, _, _ = render_orbit_sequence(1)
    levels = pyramid.build_pyramid(torch.as_tensor(imgs[0][:1], device=cuda_device), 8)
    before = cuda_fast.launches
    got = cuda_fast.fast_scores_nms_levels(levels, DETECT_MARGIN)
    torch.cuda.synchronize()
    assert cuda_fast.launches == before + 1
    for out, lvl in zip(got, levels):
        assert out.shape == lvl.shape
        assert torch.equal(out, cuda_fast.fast_scores_nms_plain(lvl, DETECT_MARGIN))


def _mono_config(rig):
    """tests/test_torch_mono.py's corridor configuration."""
    cfg = SlamConfig()
    cfg.map.max_kf, cfg.map.max_mp = 64, 4096
    cfg.orb.max_kp, cfg.orb.target_features, cfg.orb.fast_threshold = 384, 300, 12.0
    cfg.tracker.min_init_features = 150
    cfg.ba.max_points, cfg.ba.window_size = 1024, 6
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    return cfg


def _mono_init_on(dev, frames, rig):
    """`System.track_monocular` over `frames` until it initialises, the
    two-view RANSAC on host draws: (the outputs of the reconstruction that
    initialised, the initial map's (kf_t, mp_pos, mp_valid) before and
    after its BA, the initialisation frame), all on the host."""
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    got = {}

    def keep(name, real, pick, last=False):
        def f(*a, **k):
            out = real(*a, **k)
            if last or name not in got:
                got[name] = pick(out)
            return out
        return f

    def snap(m):
        return {k: getattr(m, k).cpu().numpy().copy() for k in ("kf_t", "mp_pos", "mp_valid")}

    with host_ransac_draws(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "reconstruct_two_views",
                   keep("recon", ttr.reconstruct_two_views,
                        lambda o: {k: v.cpu().numpy() for k, v in o.items()}, last=True))
        mp.setattr(ttr, "_mono_init_map",
                   keep("pre", ttr._mono_init_map, lambda o: snap(o[0])))
        # the BA after `_mono_init_map` is the initial map's
        mp.setattr(ttr, "_local_ba", keep("post", ttr._local_ba, snap))
        s = System(_mono_config(rig), "mono", device=dev, enable_loop_closing=False)
        for i, (pair, _, stamp) in enumerate(frames):
            if s.track_monocular(pair[0], stamp)["state"] == 1:
                got["frame"] = i
                break
        s.shutdown()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6, 7, 8])
def test_mono_initial_map_on_card_matches_cpu(cuda_device, seed):
    """The corridor's monocular initialisation (render seed `seed`) on the
    card and on the CPU, on the same host draws, compared without any
    alignment: the same frame, good-point count and mask; R and t within
    1e-4; the triangulated points, and the initial map (median depth 1)
    before its 20-iteration BA, within 1e-3 of their depth; after it the
    landmarks within 5e-3 and keyframe 1's translation within 1e-4.
    Observed on render seeds 5-12: R and t 9.4e-6, points 4.4e-4 of their
    depth, 1.0e-3 after the BA, keyframe 1 1.5e-6 (tools/card_divergence.py;
    NVIDIA H100 80GB HBM3, 700 W). Earlier attempts that fail the
    acceptance rule may differ by a point at a gate (66 and 67 good points
    on seed 6's first)."""
    from orbslam3lib_tpu_torch.io.synthetic import render_stereo_sequence
    frames, rig, _ = render_stereo_sequence(n_frames=8, dt=1.0 / 15.0, seed=seed)
    cpu, card = (_mono_init_on(d, frames, rig) for d in ("cpu", cuda_device))
    assert card["frame"] == cpu["frame"]
    rc, rg = cpu["recon"], card["recon"]
    assert int(rg["n_good"]) == int(rc["n_good"])
    np.testing.assert_array_equal(rg["tri_ok"], rc["tri_ok"])
    np.testing.assert_allclose(rg["R"], rc["R"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(rg["t"], rc["t"], rtol=0, atol=1e-4)
    ok = rc["tri_ok"]
    err = np.abs(rg["p3d"][ok] - rc["p3d"][ok]).max(axis=1) / rc["p3d"][ok, 2]
    assert err.max() < 1e-3, err.max()
    for stage in ("pre", "post"):
        v = cpu[stage]["mp_valid"]
        assert np.array_equal(card[stage]["mp_valid"], v)
        pg, pc = card[stage]["mp_pos"][v], cpu[stage]["mp_pos"][v]
        if stage == "pre":
            err = np.abs(pg - pc).max(axis=1) / pc[:, 2]
            assert err.max() < 1e-3, err.max()
        else:
            np.testing.assert_allclose(pg, pc, rtol=0, atol=5e-3)
        np.testing.assert_allclose(np.median(pg[:, 2]), np.median(pc[:, 2]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(card["post"]["kf_t"][1], cpu["post"]["kf_t"][1],
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_mono_system_on_card_matches_cpu(cuda_device):
    """20 frames of the corridor through `System.track_monocular` on the
    card and on the CPU, the two-view RANSAC on the same (host) draws: the
    same initialisation frame and states, the same keyframes, and the
    camera centres, with no alignment, within 1e-4 (the initial map is
    scaled to median depth 1). Observed on render seeds 5-12: at most
    8.6e-6 (tools/card_divergence.py; NVIDIA H100 80GB HBM3, 700 W)."""
    from orbslam3lib_tpu_torch.io.synthetic import render_stereo_sequence
    from orbslam3lib_tpu_torch.system import System
    frames, rig, _ = render_stereo_sequence(n_frames=20, dt=1.0 / 15.0, seed=5)
    with host_ransac_draws():
        systems = [System(_mono_config(rig), "mono", device=d, enable_loop_closing=False)
                   for d in ("cpu", cuda_device)]
        out = [[s.track_monocular(pair[0], stamp)["state"] for pair, _, stamp in frames]
               for s in systems]
    cpu, card = systems
    assert out[1] == out[0] and out[0][-1] == 1
    assert card.get_stats()["n_kf"] == cpu.get_stats()["n_kf"]
    np.testing.assert_allclose(card.tracker.trajectory_centers(),
                               cpu.tracker.trajectory_centers(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_rgbd_system_on_card_matches_cpu(cuda_device):
    """16 frames of the small orbit with their depth maps through
    `System.track_rgbd` on the card and on the CPU: the same counts, camera
    centres within 5 mm."""
    from orbslam3lib_tpu_torch.io.synthetic import orbit_depth_maps
    from orbslam3lib_tpu_torch.system import System
    imgs, ts, rig = orbit_frames(16)
    depths = orbit_depth_maps(16, rig)
    systems = [System(backend_config(SlamConfig, rig), "rgbd", device=d,
                      enable_loop_closing=False) for d in ("cpu", cuda_device)]
    for img, d, stamp in zip(imgs[:, 0], depths, ts):
        for s in systems:
            s.track_rgbd(img, d, float(stamp))
    cpu, card = systems
    assert_same_stats(card.get_stats(), cpu.get_stats())
    assert card.get_tracking_state() == cpu.get_tracking_state() == 1
    np.testing.assert_allclose(card.tracker.trajectory_centers(),
                               cpu.tracker.trajectory_centers(), rtol=0, atol=5e-3)


# -- the inertial sensors ------------------------------------------------------

def _inertial_inputs(seed: int = 3, n: int = 200):
    """A two-frame inertial problem on the corridor, numpy: the anchor's
    state at t0 and, for the frames at t1 and t2 (1/15 s apart), each
    state perturbed, the noisy IMU's samples since the frame before and
    monocular / stereo observations."""
    from orbslam3lib_tpu_torch.io.synthetic import corridor_pose_at, synth_imu
    rng = np.random.default_rng(seed)
    ts = (1.0, 1.0 + 1 / 15, 1.0 + 2 / 15)
    cam = np.array([300.0, 300.0, 320.0, 200.0], np.float32)

    def state(t):
        R_cw, c = corridor_pose_at(np.array([t, t + 1e-4, t - 1e-4]))
        R = R_cw[0].T.astype(np.float32)
        v = ((c[1] - c[2]) / 2e-4).astype(np.float32)
        return dict(R=R, t=(-R @ c[0]).astype(np.float32), v=v,
                    bg=np.zeros(3, np.float32), ba=np.zeros(3, np.float32))

    frames = []
    for t_prev, t in zip(ts[:-1], ts[1:]):
        truth = state(t)
        cur = dict(truth)
        cur["t"] = (cur["t"] + rng.normal(size=3) * 0.01).astype(np.float32)
        cur["v"] = (cur["v"] + rng.normal(size=3) * 0.05).astype(np.float32)
        imu = synth_imu(t_prev, t, freq=200.0, bg=np.array([0.002, -0.001, 0.0015]),
                        sigma_g=2.4e-3, sigma_a=2.8e-2, rng=rng)
        p_c = rng.uniform([-2, -1.5, 2], [2, 1.5, 10], size=(n, 3)).astype(np.float32)
        p_w = ((p_c - truth["t"]) @ truth["R"]).astype(np.float32)
        uv = (cam[:2] * p_c[:, :2] / p_c[:, 2:] + cam[2:] + rng.normal(0, 0.4, (n, 2))
              ).astype(np.float32)
        st = rng.uniform(size=n) < 0.5
        obs = dict(p_world=p_w, uv=uv, inv_sigma2=np.ones(n, np.float32),
                   u_right=np.where(st, uv[:, 0] - 33.0 / p_c[:, 2], 0).astype(np.float32),
                   is_stereo=st, valid=np.ones(n, bool))
        frames.append((cur, imu, obs))
    return state(ts[0]), frames, cam


H_MARG_TOL = 1e-5


@pytest.mark.cuda
def test_inertial_solvers_on_card_match_cpu(cuda_device):
    """The three inertial solvers on the card against the same calls on the
    CPU: the per-frame 15-dof solve of the first frame and, chained on its
    state and H, the 30-dof LastFrame solve of the next one (poses,
    velocities and gyro biases 1e-4, the accel bias 5e-4, inlier masks
    equal, H_marg within H_MARG_TOL of its largest entry), and the IMU
    initialisation over a chain of 13 keyframe gaps with and without scale
    (gravity, biases 1e-4; scale and velocities 1e-3). The preintegration
    runs on each device."""
    from orbslam3lib_tpu_torch.io.synthetic import corridor_pose_at, synth_imu
    from orbslam3lib_tpu_torch.tracking import imu as timu, inertial_opt as tio
    from orbslam3lib_tpu_torch.tracking.pose_opt import PoseObs
    anchor, frames, cam = _inertial_inputs()
    out = {}
    for dev in ("cpu", cuda_device):
        T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        S = lambda d: tio.InertialFrameState(**{k: T(v) for k, v in d.items()})  # noqa: E731
        (c1, (g1, a1, d1), o1), (c2, (g2, a2, d2), o2) = frames
        pre1, pre2 = (timu.integrate(timu.empty_preintegrated(device=dev), g, a, d, 2.4e-3,
                                     2.8e-2, 1.9e-5, 3e-3) for g, a, d in ((g1, a1, d1),
                                                                           (g2, a2, d2)))
        st1, m1, _, H1 = tio.pose_inertial_optimization(
            S(c1), S(anchor), pre1, PoseObs(**{k: T(v) for k, v in o1.items()}), T(cam),
            bf=33.0)
        st2, m2, _, H2 = tio.pose_inertial_optimization_last_frame(
            S(c2), st1, H1, pre2, PoseObs(**{k: T(v) for k, v in o2.items()}), T(cam), bf=33.0)
        ts = np.arange(0.5, 3.8, 0.25)
        R_cw, c = corridor_pose_at(ts)
        kf_R = np.stack([r.T for r in R_cw]).astype(np.float32)
        kf_t = (-np.einsum("kij,kj->ki", kf_R, c)).astype(np.float32)
        rng = np.random.default_rng(5)
        pres = timu.Preintegrated.stack([
            timu.integrate(timu.empty_preintegrated(device=dev),
                           *synth_imu(float(ts[i]), float(ts[i + 1]), freq=200.0,
                                      sigma_g=2.4e-3, sigma_a=2.8e-2, rng=rng),
                           2.4e-3, 2.8e-2) for i in range(len(ts) - 1)])
        inits = [tio.inertial_init_optimization(
            T(kf_R), T(kf_t), torch.ones(len(ts), dtype=torch.bool, device=dev), pres,
            torch.ones(len(ts) - 1, dtype=torch.bool, device=dev), opt_scale=s)
            for s in (False, True)]
        out[str(dev)] = (st1, m1, H1, st2, m2, H2, inits)
    c_, g_ = out["cpu"], out[str(cuda_device)]
    # one frame pins its accel bias weakly (the direction of H's smallest
    # eigenvalues): the card's and the CPU's GEMM orders moved it by 1.2e-4
    # (of 9e-3) while every other field agreed within 1e-4
    for k in (0, 3):
        for f, tol in (("R", 1e-4), ("t", 1e-4), ("v", 1e-4), ("bg", 1e-4), ("ba", 5e-4)):
            np.testing.assert_allclose(getattr(g_[k], f).cpu().numpy(),
                                       getattr(c_[k], f).numpy(), rtol=0, atol=tol, err_msg=f)
    for k in (1, 4):
        assert torch.equal(g_[k].cpu(), c_[k])
    # H_marg: with the reference's small-angle series (only below theta^2 =
    # 1e-8) the inertial edge's rows of J parted between the card and the
    # CPU in their rotation columns by up to 101 of 4,864 from the second
    # Gauss-Newton step, which moved H by 2.0% of its largest entry; with the
    # port's series the f32 derivatives are no longer rounding noise
    # (PERF.md §6: the gap measured on the card)
    for k in (2, 5):
        Hc = c_[k].numpy()
        gap = np.abs(g_[k].cpu().numpy() - Hc).max() / np.abs(Hc).max()
        print(f"H_marg {k}: card vs CPU {gap:.3g} of its largest entry")
        assert gap <= H_MARG_TOL, gap
    for ig, ic in zip(g_[6], c_[6]):
        for x, y, tol in zip(ig, ic, (1e-4, 1e-4, 1e-4, 1e-3, 1e-3)):
            np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_graphed_inertial_solve_matches_eager_on_card(cuda_device):
    """`device.GraphedCall` around the per-frame solve: captured at the
    first call, then replayed on new inputs (the two frames of
    `_inertial_inputs` in turn, twice), each equal to the eager solve on the
    card within 1e-6, with no capture falling back to eager."""
    from orbslam3lib_tpu_torch.device import GraphedCall
    from orbslam3lib_tpu_torch.tracking import imu as timu, inertial_opt as tio
    from orbslam3lib_tpu_torch.tracking.pose_opt import PoseObs
    anchor, frames, cam = _inertial_inputs(seed=4)
    T = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731

    def solve(*t):
        st, mask, n, H = tio.pose_inertial_optimization(
            tio.InertialFrameState(*t[:5]), tio.InertialFrameState(*t[5:10]),
            timu.Preintegrated(*t[10:23]), PoseObs(*t[23:29]), t[29], bf=33.0)
        return (*st, mask, n, H)

    graphed = GraphedCall(solve)
    for cur, (g, a, d), obs in frames + frames:
        pre = timu.integrate(timu.empty_preintegrated(device=cuda_device), g, a, d, 2.4e-3,
                             2.8e-2, 1.9e-5, 3e-3)
        flat = (*(T(cur[k]) for k in ("R", "t", "v", "bg", "ba")),
                *(T(anchor[k]) for k in ("R", "t", "v", "bg", "ba")),
                *(getattr(pre, f) for f in timu.TENSOR_FIELDS),
                *(T(obs[k]) for k in ("p_world", "uv", "inv_sigma2", "u_right", "is_stereo",
                                      "valid")), T(cam))
        want, got = solve(*flat), graphed(*flat)
        for x, y in zip(got, want):
            if x.dtype.is_floating_point:
                np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=0,
                                           atol=1e-6 * max(1.0, float(y.abs().max())))
            else:
                assert torch.equal(x, y)
    assert len(graphed.graphs) == 1 and not graphed.eager


@pytest.mark.cuda
@pytest.mark.parametrize("per_kf_bias", [False, True])
def test_local_inertial_ba_on_card_matches_cpu(cuda_device, per_kf_bias):
    """`local_inertial_ba` and `apply_vi_window` on tests/test_vi_ba.py's
    window (built JAX-free, `torch_parity.vi_window`) on the card against
    the CPU: poses 1e-4, velocities 1e-3, biases 1e-4; the fixed anchor
    untouched."""
    from orbslam3lib_tpu_torch.mapping import vi_ba
    from orbslam3lib_tpu_torch.models import map_state as ms
    from torch_parity import vi_window
    arr, pres = vi_window()
    C = 6
    out = {}
    for dev in ("cpu", cuda_device):
        m = ms.from_numpy(arr, device=dev)
        ids = torch.arange(C, dtype=torch.int32, device=dev)
        fixed = torch.zeros(C, dtype=torch.bool, device=dev)
        fixed[0] = True
        res = vi_ba.local_inertial_ba(
            m, ids, fixed, pres.to(dev), torch.ones(C - 1, dtype=torch.bool, device=dev),
            torch.zeros(3, device=dev), torch.zeros(3, device=dev),
            torch.tensor([300.0, 300.0, 320.0, 200.0], device=dev), bf=0.0, n_iters=8,
            per_kf_bias=per_kf_bias)
        vi_ba.apply_vi_window(m, ids, fixed, res)
        out[str(dev)] = (res, m)
    (rc, mc), (rg, mg) = out["cpu"], out[str(cuda_device)]
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("v", 1e-3), ("bg", 1e-4), ("ba", 1e-4)):
        np.testing.assert_allclose(getattr(rg, f).cpu().numpy(), getattr(rc, f).numpy(),
                                   rtol=0, atol=tol, err_msg=f)
    assert torch.equal(mg.kf_R[0].cpu(), torch.from_numpy(arr["kf_R"][0]))


@pytest.mark.cuda
def test_imu_mono_on_card_matches_cpu(cuda_device):
    """`System(cfg, "imu_mono")` on the corridor's first 33 frames with its
    IMU, on the card and on the CPU, the two-view RANSAC on the same host
    draws: the same states, keyframes and inertial initialisation attempts
    (two, at the 7th and 8th keyframe, both under the 0.1 scale guard: the
    reference's own never initialises on this corridor, ROADMAP queue 3),
    the attempts' scales within 1e-3, camera centres within 1e-3."""
    from orbslam3lib_tpu_torch.io.synthetic import corridor_imu_stream, render_stereo_sequence
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    frames, rig, _ = render_stereo_sequence(n_frames=33, dt=1.0 / 15.0, seed=5)
    ts = np.array([f[2] for f in frames])
    ci = SlamConfig().imu
    imu = corridor_imu_stream(ts, ci.noise_gyro, ci.noise_acc, ci.freq,
                              (0.002, -0.001, 0.0015), (0.02, -0.01, 0.015), seed=0)
    attempts = {}
    real = ttr.inertial_init_optimization

    def logged(kf_R, *a, **k):
        out = real(kf_R, *a, **k)
        attempts.setdefault(str(kf_R.device), []).append(float(out[3]))
        return out

    with host_ransac_draws(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "inertial_init_optimization", logged)
        systems = [System(_mono_config(rig), "imu_mono", device=d, enable_loop_closing=False)
                   for d in ("cpu", cuda_device)]
        states = [[s.track_monocular(pair[0], stamp, imu=x)["state"]
                   for (pair, _, stamp), x in zip(frames, imu)] for s in systems]
    cpu, card = systems
    assert states[1] == states[0] and states[0][-1] == 1
    assert card.get_stats()["n_kf"] == cpu.get_stats()["n_kf"]
    sc, sg = attempts["cpu"], attempts[str(cuda_device)]
    assert len(sc) == len(sg) >= 1
    np.testing.assert_allclose(sg, sc, rtol=0, atol=1e-3)
    assert card.tracker.imu_ready == cpu.tracker.imu_ready
    np.testing.assert_allclose(card.tracker.trajectory_centers(),
                               cpu.tracker.trajectory_centers(), rtol=0, atol=1e-3)


# the excited corridor of chip_smoke.py's phase J (IMU_MONO_SPEED, IMU_MONO_WIGGLE)
IMU_MONO_SPEED, IMU_MONO_WIGGLE = 2.0, 1.2
N_IMU_MONO_FRAMES = 40


@pytest.mark.cuda
def test_imu_mono_initialises_on_card_like_cpu(cuda_device):
    """`System(cfg, "imu_mono")` on the corridor driven at IMU_MONO_SPEED
    with a sway of IMU_MONO_WIGGLE (tests/test_torch_imu_mono.py's
    sequence), on the card and on the CPU, the two-view RANSAC on the same
    host draws, through a successful IMU initialisation: the same states
    and keyframes, `imu_ready` true from the same frame on both devices,
    every attempt's scale within 1e-3 (the last one passing the 0.1 guard),
    camera centres within 1e-3."""
    from orbslam3lib_tpu_torch.io.synthetic import corridor_imu_stream, render_corridor_mono
    from orbslam3lib_tpu_torch.system import System
    from orbslam3lib_tpu_torch.tracking import tracker as ttr
    imgs, ts, rig = render_corridor_mono(N_IMU_MONO_FRAMES, seed=5, speed=IMU_MONO_SPEED,
                                         wiggle=IMU_MONO_WIGGLE)
    ci = SlamConfig().imu
    imu = corridor_imu_stream(ts, ci.noise_gyro, ci.noise_acc, ci.freq,
                              (0.002, -0.001, 0.0015), (0.02, -0.01, 0.015), seed=0,
                              speed=IMU_MONO_SPEED, wiggle=IMU_MONO_WIGGLE)
    attempts = {}
    real = ttr.inertial_init_optimization

    def logged(kf_R, *a, **k):
        out = real(kf_R, *a, **k)
        attempts.setdefault(str(kf_R.device), []).append(float(out[3]))
        return out

    ready = {}
    with host_ransac_draws(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "inertial_init_optimization", logged)
        systems = [System(_mono_config(rig), "imu_mono", device=d, enable_loop_closing=False)
                   for d in ("cpu", cuda_device)]
        states = []
        for s in systems:
            states.append([])
            for i in range(N_IMU_MONO_FRAMES):
                states[-1].append(s.track_monocular(imgs[i], float(ts[i]), imu=imu[i])["state"])
                if s.tracker.imu_ready:
                    ready.setdefault(str(s.tracker.device), i)
    cpu, card = systems
    assert states[1] == states[0]
    assert card.get_stats()["n_kf"] == cpu.get_stats()["n_kf"]
    assert ready["cpu"] == ready[str(card.tracker.device)]
    sc, sg = attempts["cpu"], attempts[str(card.tracker.device)]
    assert len(sc) == len(sg) >= 1 and sc[-1] >= 0.1 and sg[-1] >= 0.1
    np.testing.assert_allclose(sg, sc, rtol=0, atol=1e-3)
    np.testing.assert_allclose(card.tracker.trajectory_centers(),
                               cpu.tracker.trajectory_centers(), rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_inertial_merge_on_card_matches_cpu(cuda_device):
    """The inertial merge (`MapMerger.inertial`: yaw-only weld, scale 1,
    the [0.9, 1.1] gate) on `torch_parity.merge_ring_maps` with map B in a
    gravity-aligned world, on the card against the CPU on the same draws:
    the same decision and remapped registry, integer fields equal, poses
    and landmarks within 1e-3; kernel 2 ran inside it."""
    from orbslam3lib_tpu_torch.mapping import loop_closing as lc
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.models import vocabulary as vb
    from orbslam3lib_tpu_torch.models.atlas import Atlas
    from orbslam3lib_tpu_torch.tracking.reloc import PlaceRecognition
    from torch_parity import merge_ring_maps
    c_, s_ = np.cos(0.35), np.sin(0.35)
    G = (np.array([[c_, 0, s_], [0, 1, 0], [-s_, 0, c_]], np.float32),
         np.array([0.4, 0.1, -0.2], np.float32), 1.0)
    a, b, _, _, descs = merge_ring_maps(thetas_b=(2.4, 2.8, 3.2, 0.05), G=G)
    out = {}
    with host_ransac_draws():
        for dev in ("cpu", cuda_device):
            voc = vb.train_vocabulary(descs, k=4, depth=3).to(dev)
            at = Atlas(32, 1024, 160, device=dev)
            at.maps = [ms.from_numpy(a, device=dev), ms.from_numpy(b, device=dev)]
            at.bad, at.current = [False, False], 1
            db = PlaceRecognition(voc, 32)
            for i in range(int(at.maps[0].n_kf)):
                db.add(i, at.maps[0].kf_desc[i], at.maps[0].kf_feat_valid[i])
            cfg = SlamConfig()
            cfg.camera.fx = cfg.camera.fy = 300.0
            cfg.camera.cx, cfg.camera.cy = 320.0, 200.0
            merger = lc.MapMerger(cfg, consistency_needed=1)
            merger.inertial = True
            merger.archive(0, db, gaps={k: (k - 1, None) for k in range(1, 5)})
            before = cuda_matcher.launches
            done = merger.on_keyframe(at, 3, torch.from_numpy(RING_CAM).to(dev))
            out[str(dev)] = (done, at, merger.last_merge, cuda_matcher.launches - before)
    (dc, ac, lc_, _), (dg, ag, lg, n_launch) = out["cpu"], out[str(cuda_device)]
    assert dc and dg and n_launch >= 1
    assert sorted(lg["gaps"]) == sorted(lc_["gaps"]) == [5, 6, 7, 8]
    for k in ms.FIELDS:
        x, y = getattr(ag.current_map, k).cpu(), getattr(ac.current_map, k)
        if x.dtype == torch.float32:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-3, err_msg=k)
        else:
            assert torch.equal(x, y), k


@pytest.mark.cuda
def test_feed_imu_graph_on_card_matches_cpu(cuda_device):
    """`Tracker.feed_imu` on the card (both preintegrations integrated from a
    CUDA graph per sample count) against the CPU tracker's on the same
    corridor samples, chunks of 13, 14 and 13: every field within 1e-5 of
    its largest entry, the host totals equal, two graphs and no eager
    fallback."""
    from orbslam3lib_tpu_torch.io.synthetic import corridor_imu_stream
    from orbslam3lib_tpu_torch.tracking import imu as timu
    ts = np.array([0.0, 0.065, 0.135, 0.2])
    ci = SlamConfig().imu
    chunks = corridor_imu_stream(ts, ci.noise_gyro, ci.noise_acc, ci.freq, seed=2)[1:]
    assert [len(c[2]) for c in chunks] == [13, 14, 13]
    trs = []
    for dev in ("cpu", cuda_device):
        cfg = SlamConfig()
        cfg.use_imu = True
        tr = Tracker(cfg, "stereo", device=dev, enable_loop_closing=False)
        for c in chunks:
            tr.feed_imu(*c)
            if tr._pre_frame.dt_host > 0.1:      # a frame consumed mid-way
                tr._pre_frame = None
        trs.append(tr)
    cpu, card = trs
    for name in ("_pre_frame", "_pre_kf"):
        a, b = getattr(card, name), getattr(cpu, name)
        assert a.dt_host == b.dt_host
        for f in timu.TENSOR_FIELDS:
            y = getattr(b, f).numpy()
            np.testing.assert_allclose(getattr(a, f).cpu().numpy(), y, rtol=0,
                                       atol=1e-5 * max(float(np.abs(y).max()), 1e-30), err_msg=f)
    assert len(card._integrate_pair.graphs) == 2 and not card._integrate_pair.eager


@pytest.mark.cuda
def test_sharded_frontend_on_card(cuda_device):
    """`make_sharded_frontend` over DeviceMesh(["cuda:0"] * 2) on 8 frames of
    the small orbit, each shard's frames in one launch of kernel 1, against
    `extract_orb_stereo` + `match_rectified_stereo` frame by frame on the
    card: keypoints, levels, validity and descriptors equal, u_r and depth
    within 1e-4."""
    from orbslam3lib_tpu_torch.ops.extractor import extract_orb_stereo
    from orbslam3lib_tpu_torch.parallel.dist_ba import DeviceMesh
    from orbslam3lib_tpu_torch.parallel.dist_frontend import make_sharded_frontend
    from orbslam3lib_tpu_torch.tracking.matching import match_rectified_stereo
    imgs, _, _ = orbit_frames(8)
    ths = torch.tensor([12.0, 14.0, 16.0, 17.0] * 2)
    front = make_sharded_frontend(DeviceMesh([cuda_device] * 2), bf=22.5, min_z=0.3,
                                  max_kp=256, n_levels=4)
    before = cuda_fast.launches
    out = front(torch.from_numpy(imgs), ths)
    torch.cuda.synchronize()
    assert cuda_fast.launches == before + 2
    for g in range(8):
        f, ur, depth = out[g // 4]
        i = g % 4
        ref = extract_orb_stereo(torch.from_numpy(imgs[g]).to(cuda_device), float(ths[g]),
                                 max_kp=256, n_levels=4)
        r_ur, r_d = match_rectified_stereo(ref.xy[0], ref.level[0], ref.desc[0], ref.valid[0],
                                           ref.xy[1], ref.level[1], ref.desc[1], ref.valid[1],
                                           22.5, 0.3, n_levels=4)
        for name in ("xy", "level", "valid", "desc"):
            assert torch.equal(getattr(f, name)[i], getattr(ref, name)), (g, name)
        assert float((ur[i] - r_ur).abs().max()) <= 1e-4
        assert float((depth[i] - r_d).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_native_bow_against_dense_on_card(cuda_device):
    """The native database (built with g++) against the dense one on the
    card, on the ring world's keyframes: word ids equal to the card's
    descent, scores within 1e-5, top-3 candidates equal."""
    from orbslam3lib_tpu_torch import native
    from orbslam3lib_tpu_torch.models import vocabulary as vb
    from orbslam3lib_tpu_torch.tracking.reloc import PlaceRecognition
    arrays, _, _ = ring_world()
    voc = vb.load_vocabulary(vb.DEFAULT_VOCAB_PATH, device=cuda_device)
    K, n = arrays["kf_R"].shape[0], int(arrays["n_kf"])
    nb, dense = native.NativeBowDatabase(voc, K), PlaceRecognition(voc, K)
    nvoc = native.NativeVocabulary(voc)
    for k in range(n):
        d = torch.from_numpy(arrays["kf_desc"][k]).to(cuda_device)
        v = torch.from_numpy(arrays["kf_feat_valid"][k]).to(cuda_device)
        assert np.array_equal(nvoc.word_ids(d), vb.word_ids(voc, d).cpu().numpy())
        nb.add(k, d, v)
        dense.add(k, d, v)
    for k in range(n):
        d = torch.from_numpy(arrays["kf_desc"][k]).to(cuda_device)
        v = torch.from_numpy(arrays["kf_feat_valid"][k]).to(cuda_device)
        ids_n, s_n = nb.query(d, v, n_best=3)
        ids_d, s_d = dense.query(d, v, n_best=3)
        assert np.array_equal(ids_n, ids_d.cpu().numpy()), k
        np.testing.assert_allclose(s_n, s_d.cpu().numpy(), rtol=0, atol=1e-5)


def _pose_inputs(n, seed, device):
    from orbslam3lib_tpu_torch.tracking import pose_opt
    from torch_parity import POSE_CAM, pose_problem
    obs, _, (R0, t0) = pose_problem(n, seed)
    o = pose_opt.PoseObs(**{k: torch.from_numpy(v).to(device) for k, v in obs.items()})
    return o, torch.from_numpy(R0).to(device), torch.from_numpy(t0).to(device), \
        torch.from_numpy(POSE_CAM).to(device)


def _rel_err(got, want, floor=1.0) -> float:
    """Largest |got - want| over max(|want|, floor): a relative error, and
    an absolute one for values below `floor`."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp(min=floor)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 1200, 77])
def test_pose_eval_kernel_matches_torch_on_card(cuda_device, n):
    """One evaluation by the kernel against the torch path on the card, on
    mono, stereo, invalid, outlier, behind-camera and z ~ 0 rows (77: less
    than one block)."""
    from orbslam3lib_tpu_torch.ops import cuda_pose
    from orbslam3lib_tpu_torch.tracking import pose_opt
    from orbslam3lib_tpu_torch.utils import cameras
    from torch_parity import POSE_BF
    o, R0, t0, cam = _pose_inputs(n, n, cuda_device)
    before = cuda_pose.eval_launches
    got = pose_opt._residuals_jacobians(R0, t0, o, cameras.PINHOLE, cam, POSE_BF)
    torch.cuda.synchronize()
    assert cuda_pose.eval_launches == before + 1
    want = pose_opt._residuals_jacobians_torch(R0, t0, o, cameras.PINHOLE, cam, POSE_BF)
    for name, g, w in zip(("r", "J", "chi2"), got[:3], want[:3]):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel_err(g, w) <= 1e-5, (name, _rel_err(g, w))
    assert got[3].dtype == torch.bool and torch.equal(got[3], want[3])


@pytest.mark.cuda
def test_pose_step_kernel_matches_torch_on_card(cuda_device):
    """One Gauss-Newton step (a solve of one round of one iteration) by the
    kernels against the torch path on the card, from the same evaluation."""
    from orbslam3lib_tpu_torch.ops import cuda_pose
    from orbslam3lib_tpu_torch.tracking import pose_opt
    from orbslam3lib_tpu_torch.utils import cameras
    from orbslam3lib_tpu_torch.utils.robust import DELTA_MONO, DELTA_STEREO
    from torch_parity import POSE_BF
    o, R0, t0, cam = _pose_inputs(1200, 3, cuda_device)
    before = cuda_pose.step_launches
    R1, t1, _, _ = pose_opt.pose_optimization(R0, t0, o, cam, bf=POSE_BF, n_rounds=1,
                                              iters_per_round=1)
    torch.cuda.synchronize()
    assert cuda_pose.step_launches == before + 1
    ev = pose_opt._residuals_jacobians_torch(R0, t0, o, cameras.PINHOLE, cam, POSE_BF)
    R2, t2 = pose_opt._step_torch(R0, t0, *ev, o.inv_sigma2,
                                  torch.where(o.is_stereo, DELTA_STEREO, DELTA_MONO),
                                  torch.ones_like(o.inv_sigma2), o.valid.float(), 1e-3)
    assert float((R1 - R2).abs().max()) <= 1e-6
    assert float((t1 - t2).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n_rounds,iters", [(2, 2), (4, 10)])
def test_pose_solve_kernels_match_torch_on_card(cuda_device, monkeypatch, n_rounds, iters):
    """Whole solves at the orbit's and EuRoC's schedules: the kernels'
    launches, and pose and inliers against the torch path on the card (the
    inlier masks away from chi2 ties: within 1% of the gate)."""
    from orbslam3lib_tpu_torch.ops import cuda_pose
    from orbslam3lib_tpu_torch.tracking import pose_opt
    from orbslam3lib_tpu_torch.utils import cameras
    from torch_parity import POSE_BF
    o, R0, t0, cam = _pose_inputs(1200, 11, cuda_device)
    launches = cuda_pose.eval_launches, cuda_pose.step_launches
    Rk, tk, inl_k, n_k = pose_opt.pose_optimization(R0, t0, o, cam, bf=POSE_BF,
                                                    n_rounds=n_rounds, iters_per_round=iters)
    torch.cuda.synchronize()
    assert cuda_pose.eval_launches - launches[0] == n_rounds * (iters + 1)
    assert cuda_pose.step_launches - launches[1] == n_rounds * iters
    monkeypatch.setattr(pose_opt, "_fused", lambda R, model: False)
    Rt, tt, inl_t, n_t = pose_opt.pose_optimization(R0, t0, o, cam, bf=POSE_BF,
                                                    n_rounds=n_rounds, iters_per_round=iters)
    assert float((Rk - Rt).abs().max()) <= 1e-5
    assert float((tk - tt).abs().max()) <= 1e-5
    _, _, chi2, _ = pose_opt._residuals_jacobians(Rt, tt, o, cameras.PINHOLE, cam, POSE_BF)
    th = torch.where(o.is_stereo, 7.815, 5.991)
    away = (chi2 - th).abs() > 0.01 * th
    assert torch.equal(inl_k[away], inl_t[away])
    assert abs(int(n_k) - int(n_t)) <= int((~away).sum())


@pytest.mark.cuda
def test_pose_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """Wrong widths, dtypes or devices raise before any pointer is passed."""
    from orbslam3lib_tpu_torch.ops import cuda_pose
    from torch_parity import POSE_BF
    o, R0, t0, cam = _pose_inputs(64, 1, cuda_device)
    before = cuda_pose.eval_launches
    bad = [(o._replace(uv=o.uv[:, :1].contiguous()), R0, cam),
           (o._replace(p_world=o.p_world[:32]), R0, cam),
           (o._replace(is_stereo=o.is_stereo.float()), R0, cam),
           (o, R0.double(), cam),
           (o, R0, cam.cpu()),
           (o._replace(u_right=o.u_right.cpu()), R0, cam)]
    for obs, R, c in bad:
        with pytest.raises(ValueError):
            cuda_pose.pose_eval(R, t0, obs, c, POSE_BF)
    assert cuda_pose.eval_launches == before
    r, J, chi2, behind = cuda_pose.pose_eval(R0, t0, o, cam, POSE_BF)
    ones = torch.ones(64, device=cuda_device)
    with pytest.raises(ValueError):
        cuda_pose.pose_step(R0, t0, r, J[:, :2], chi2, behind, o.inv_sigma2, ones, ones,
                            ones, 1e-3)


# -- the VI window's kernels (csrc/vi_opt.cu) --

def _vi_window(dev, C=9, F=1200, bf=33.0, seed=17, **kw):
    """`torch_parity.vi_problem`'s window on `dev` (EuRoC's C = 9 and F =
    1,200 by default; points enough that every slot observes one)."""
    from torch_parity import vi_problem
    return vi_problem(C=C, F=F, n_pts=max(256, 2 * F), bf=bf, seed=seed, device=dev, **kw)


def _vi_x(C: int, dev, seed: int = 3):
    """A seeded x: poses ~0.02, velocities ~0.05, biases ~1e-3, one
    keyframe's rotation past the Lie series (theta ~ 0.45)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, 15)) * np.array([0.02] * 6 + [0.05] * 3 + [1e-3] * 6)
    x[1, 3:6] = [0.3, -0.2, 0.25]
    return torch.from_numpy(x.reshape(-1).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("C,bf", [(9, 33.0), (24, 33.0), (9, 0.0)])
def test_vi_eval_matches_its_oracle_on_card(cuda_device, C, bf):
    """H and g as `vi_eval` and `vi_step` assemble them at a non-zero x
    against `vi_ba._normal_equations_torch` in float64 on the same float32
    inputs: each entry of H within 2e-5 of sqrt(H_ii H_jj), of g within
    2e-5 of sqrt(H_ii) max_j |g_j| / sqrt(H_jj) (f32 rows, f64 sums); one
    launch each."""
    from orbslam3lib_tpu_torch.mapping import vi_ba
    from orbslam3lib_tpu_torch.ops import cuda_vi
    from torch_parity import vi_window_as
    m, kw = _vi_window(cuda_device, C=C, bf=bf, no_imu=(3,))
    w = vi_ba.window_problem(m, **kw)
    x = _vi_x(C, cuda_device)
    before = cuda_vi.eval_launches, cuda_vi.step_launches
    H, g = cuda_vi.normal_equations(cuda_vi.pack(w), x)
    torch.cuda.synchronize()
    assert (cuda_vi.eval_launches, cuda_vi.step_launches) == (before[0] + 1, before[1] + 1)
    H_o, g_o = vi_ba._normal_equations_torch(vi_window_as(w, torch.float64), x.double())
    d = torch.sqrt(torch.diagonal(H_o))
    gap_H = float(((H - H_o).abs() / (d[:, None] * d[None, :])).max())
    gap_g = float(((g - g_o).abs() / (d * (g_o / d).abs().max())).max())
    assert gap_H <= 2e-5 and gap_g <= 2e-5, (gap_H, gap_g)


def _vi_solve(m, kw, n_iters=10, fused=True, monkeypatch=None):
    from orbslam3lib_tpu_torch.mapping import vi_ba
    if not fused:
        monkeypatch.setattr(vi_ba, "_fused", lambda *a: False)
    try:
        return vi_ba.local_inertial_ba(m, n_iters=n_iters, **kw)
    finally:
        if not fused:
            monkeypatch.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("C,bf,case", [(9, 33.0, {}), (9, 0.0, {}), (24, 33.0, {}),
                                       (9, 33.0, dict(pad=3, no_imu=(2,), fixed=(0, 4)))])
def test_vi_window_kernels_match_torch_path_on_card(cuda_device, monkeypatch, C, bf, case):
    """Whole windows (10 iterations) by the kernels against the torch path
    (forward-mode AD, f32 LU) on the card: poses 1e-4, velocities 1e-3,
    biases 1e-4 (test_local_inertial_ba_on_card_matches_cpu's bounds); one
    `vi_eval` and one `vi_step` launch an iteration and no torch
    evaluation; the fixed keyframes held."""
    from orbslam3lib_tpu_torch.mapping import vi_ba
    from orbslam3lib_tpu_torch.ops import cuda_vi
    m, kw = _vi_window(cuda_device, C=C, bf=bf, **case)
    before = cuda_vi.eval_launches, cuda_vi.step_launches, vi_ba.evals_torch
    got = _vi_solve(m, kw)
    torch.cuda.synchronize()
    assert (cuda_vi.eval_launches - before[0], cuda_vi.step_launches - before[1],
            vi_ba.evals_torch - before[2]) == (10, 10, 0)
    want = _vi_solve(m, kw, fused=False, monkeypatch=monkeypatch)
    assert vi_ba.evals_torch - before[2] == 10
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("v", 1e-3), ("bg", 1e-4), ("ba", 1e-4)):
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0, atol=tol,
                                   err_msg=f)
    ids = kw["window_ids"].long()
    for k in case.get("fixed", (0,)):     # held: their start, projected onto SO(3)
        assert float((got.kf_R[k] - m.kf_R[ids[k]]).abs().max()) <= 1e-6
        assert float((got.kf_t[k] - m.kf_t[ids[k]]).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_vi_window_kernels_repeat_and_keep_their_results(cuda_device):
    """Two runs of one window are bit-equal; a result is not touched by a
    later window's run (every output a tensor of its own call)."""
    m, kw = _vi_window(cuda_device)
    first = _vi_solve(m, kw)
    kept = [x.clone() for x in first]
    again = _vi_solve(m, kw)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    m2, kw2 = _vi_window(cuda_device, seed=29)
    other = _vi_solve(m2, kw2)
    torch.cuda.synchronize()
    for a, b, c in zip(first, kept, other):
        assert torch.equal(a, b) and a.data_ptr() != c.data_ptr()
    ptrs = [x.data_ptr() for x in first]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.cuda
def test_vi_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """CPU and float64 windows, the shared bias, too many keyframes and
    misshapen x or slots raise before any launch."""
    from orbslam3lib_tpu_torch.mapping import vi_ba
    from orbslam3lib_tpu_torch.ops import cuda_vi
    m, kw = _vi_window(cuda_device, C=6, F=128)
    w = vi_ba.window_problem(m, **kw)
    before = cuda_vi.eval_launches, cuda_vi.step_launches
    m_cpu, kw_cpu = _vi_window("cpu", C=6, F=128)
    m64, kw64 = _vi_window(cuda_device, C=6, F=128, dtype=torch.float64)
    for bad in (vi_ba.window_problem(m_cpu, **kw_cpu), vi_ba.window_problem(m64, **kw64),
                w._replace(per_kf_bias=False), w._replace(t0=w.t0[:, :2]),
                w._replace(gap_ok=w.gap_ok[:-1])):
        with pytest.raises(ValueError):
            cuda_vi.pack(bad)
    p = cuda_vi.pack(w)
    x = torch.zeros(15 * 6, device=cuda_device)
    for bad_x in (x[:-1], x.double(), x.cpu()):
        with pytest.raises(ValueError):
            cuda_vi.vi_eval(p, bad_x)
    part = cuda_vi.vi_eval(p, x)
    for bad_part in (part[:-1], part.float()):
        with pytest.raises(ValueError):
            cuda_vi.vi_step(p, bad_part, x)
    assert (cuda_vi.eval_launches, cuda_vi.step_launches) == (before[0] + 1, before[1])
