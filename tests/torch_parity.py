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


def orbit_frames(n_frames: int, rig_kw=None, seed: int = 0):
    """bench.py's room-orbit sequence (world, trajectory, noise seed) at a
    reduced rig size, rendered with the port's numpy renderer (which renders
    the same frames as the reference's, test_torch_config.py). Returns
    (uint8 (n, 2, H, W), timestamps, rig)."""
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, render_orbit_sequence
    rig = StereoRig(**(SMALL_RIG if rig_kw is None else rig_kw))
    return render_orbit_sequence(n_frames, rig, seed)


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
