"""The port's CUDA kernels against their plain PyTorch versions; the slice
with its back end, the loop leg (probe, verification, correction, global
BA), relocalisation, the rectifying remap, the fisheye matcher, `System`
on a raw radtan and a KB8 rig, compaction and the pipelined tracker on the
card against the same on the CPU; a chunk's dispatch without a host sync;
the mapper and GBA threads on the card; the cross-map match, the map merge
and an atlas round trip on the card; kernel 1 at batch 1 and `System` with
the monocular and the RGB-D sensor on the card against the CPU (marker
`cuda`; skipped without a card). Imports no JAX, so it runs on a
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
    assert card.stats == cpu.stats and cpu.stats["n_local_ba"] >= 2
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
    assert card.get_stats() == cpu.get_stats()
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
    assert card.stats == cpu.stats and cpu.stats["n_compactions"] >= 1
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
    assert card.stats == cpu.stats and cpu.stats["n_kf"] >= 10
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
    assert card.get_stats() == cpu.get_stats()
    assert card.get_tracking_state() == cpu.get_tracking_state() == 1
    np.testing.assert_allclose(card.tracker.trajectory_centers(),
                               cpu.tracker.trajectory_centers(), rtol=0, atol=5e-3)
