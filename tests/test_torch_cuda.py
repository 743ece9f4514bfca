"""The port's CUDA kernels against their plain PyTorch versions; the slice
with its back end, the loop leg (probe, verification, correction, global
BA), relocalisation, the rectifying remap, the fisheye matcher, `System`
on a raw radtan and a KB8 rig, and compaction on the card against the same
on the CPU (marker
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


def _ring_on(dev):
    from orbslam3lib_tpu_torch.models import map_state as ms
    from orbslam3lib_tpu_torch.models import vocabulary as vb
    from orbslam3lib_tpu_torch.tracking.reloc import PlaceRecognition
    arrays, _, descs = ring_world()
    voc = vb.train_vocabulary(descs, k=4, depth=3).to(dev)
    m = ms.from_numpy(arrays, device=dev)
    pr = PlaceRecognition(voc, m.max_kf)
    for i in range(13):
        pr.add(i, m.kf_desc[i], m.kf_feat_valid[i])
    return m, pr


@pytest.mark.cuda
def test_loop_verification_and_correction_on_card_match_cpu(cuda_device):
    """The ring world's loop (tests/test_torch_loop.py), probed, verified
    and corrected with the global BA on the card and on the CPU, the
    RANSACs on the same draws: the probe pack and the verification counts
    equal, the Sim3 within 1e-4, corrected poses and landmarks within 1e-4;
    kernel 2 ran on the card (probe and verification)."""
    from orbslam3lib_tpu_torch.mapping import loop_closing as lc
    out = {}
    with host_ransac_draws():
        for dev in ("cpu", cuda_device):
            m, pr = _ring_on(dev)
            cam = torch.from_numpy(RING_CAM).to(dev)
            voc = pr.voc
            before = cuda_matcher.launches
            probe = lc.loop_probe(m, pr.bow_db, pr.active, voc.centroids, voc.idf, 12,
                                  k=voc.k, depth=voc.depth, prev_cand=-1).cpu().numpy()
            closer = lc.LoopCloser(SlamConfig(), pr, consistency_needed=1)
            m = closer.on_probe_result(m, 12, probe, cam)
            out[str(dev)] = (probe, closer, m, cuda_matcher.launches - before)
    (p_c, c_c, m_c, _), (p_g, c_g, m_g, n_launch) = out["cpu"], out[str(cuda_device)]
    assert n_launch >= 2
    np.testing.assert_array_equal(p_g[[0, 1, 2, 6, 7, 8, 10]], p_c[[0, 1, 2, 6, 7, 8, 10]])
    np.testing.assert_allclose(p_g, p_c, rtol=0, atol=1e-6)
    assert c_g.n_loops == c_c.n_loops == 1
    pg, pc = c_g.last_verification[2], c_c.last_verification[2]
    np.testing.assert_array_equal(pg[:5], pc[:5])
    np.testing.assert_allclose(pg[5:], pc[5:], rtol=0, atol=1e-4)
    for f in ("kf_R", "kf_t", "mp_pos"):
        np.testing.assert_allclose(getattr(m_g, f).cpu().numpy(), getattr(m_c, f).numpy(),
                                   rtol=0, atol=1e-4, err_msg=f)


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
