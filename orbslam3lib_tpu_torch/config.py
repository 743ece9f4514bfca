"""Typed configuration tree for the whole engine (numpy only).

A field-for-field copy of `orbslam3lib_tpu/config.py`: that module cannot be
imported here, because importing anything under `orbslam3lib_tpu` first runs
its package `__init__`, which imports JAX. `tests/test_torch_config.py` holds
the two dataclass trees equal (field names and defaults), but for the
port's own field `MappingConfig.mapper_thread`.

Replaces the reference's YAML `Settings` class (Settings.cc:36-177: versioned
typed reader with camera1/camera2/Tlr/IMU/ORB/viewer sections) with one
dataclass tree; `from_yaml` accepts EuRoC/TUM-style ORB-SLAM3 config files
(File.version 1.0 key naming) for drop-in compatibility.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass
class CameraConfig:
    model: str = "pinhole"            # "pinhole" | "kannala_brandt8"
    fx: float = 300.0
    fy: float = 300.0
    cx: float = 320.0
    cy: float = 200.0
    k: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)  # KB8 coeffs
    # radial-tangential distortion (pinhole only): k1, k2, p1, p2, k3
    # (reference Settings.cc:485 distCoeffs). Non-zero -> PINHOLE_RADTAN:
    # mono/RGB-D consume raw distorted images natively; rectified stereo
    # precomputes remap maps (utils/rectify.py)
    dist: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    width: int = 640
    height: int = 400

    @property
    def has_dist(self) -> bool:
        return self.model == "pinhole" and any(d != 0.0 for d in self.dist)

    @property
    def params(self) -> np.ndarray:
        if self.model == "pinhole":
            if self.has_dist:
                return np.asarray([self.fx, self.fy, self.cx, self.cy,
                                   *self.dist], np.float32)
            return np.asarray([self.fx, self.fy, self.cx, self.cy], np.float32)
        return np.asarray([self.fx, self.fy, self.cx, self.cy, *self.k], np.float32)

    @property
    def model_id(self) -> int:
        from .utils import cameras
        if self.model == "pinhole":
            return cameras.PINHOLE_RADTAN if self.has_dist else cameras.PINHOLE
        return cameras.KANNALA_BRANDT


@dataclass
class StereoConfig:
    baseline: float = 0.11            # meters
    min_z: float = 0.3                # nearest matchable depth
    depth_factor: float = 40.0        # close-point threshold = factor*baseline
                                      # (reference thDepth semantics, Settings)
    sad_refine: bool = True           # 11x11 SAD sub-pixel refinement of
                                      # rectified matches (Frame.cc:897-997)
    fisheye: bool = False             # two-camera non-rectified path:
                                      # kNN dist<70 + TriangulateMatches
                                      # (Frame.cc:1142 — the production path)
    rectify: bool = False             # raw distorted input: precompute
                                      # rectification maps and remap frames
                                      # on device (Settings.cc:177/485)
    R_lr: Optional[Tuple] = None      # right-cam pose in left frame (3x3
                                      # row-major); None = identity
    t_lr: Optional[Tuple] = None      # None = (baseline, 0, 0)


@dataclass
class ImuConfig:
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    freq: float = 200.0
    # T_bc: IMU-from-camera extrinsic
    R_bc: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)
    t_bc: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclass
class OrbConfig:
    max_kp: int = 512                 # feature capacity per image
    n_levels: int = 8
    target_features: int = 350        # dynamic-threshold controller target
    threshold_band: int = 60
    fast_threshold: float = 17.0      # initial (reference legacy 17/17)


@dataclass
class TrackerConfig:
    min_init_features: int = 500      # stereo init gate (Tracking.cc:2393)
    match_radius_coarse: float = 7.0  # motion-model search window
    match_radius_fine: float = 3.0    # local-map refinement window
    min_inliers: int = 15             # TrackLocalMap accept (visual)
    max_frames_between_kf: int = 15   # c1a (== fps)
    min_frames_between_kf: int = 3    # c1b spacing (synchronous mapper)
    kf_ref_ratio: float = 0.75        # c2 thRefRatio stereo
    close_tracked_th: int = 100       # c1c nTrackedClose
    close_untracked_th: int = 70      # c1c nNonTrackedClose
    pose_rounds: int = 4
    pose_iters: int = 10
    # discard landmarks farther than this many meters from the camera
    # (reference thFarPoints, System.cc:174-184 -> LocalMapping.cc:696);
    # 0 = disabled
    th_far_points: float = 0.0
    # restrict the stage-2 search to the covisibility-local map
    # (TrackLocalMap's UpdateLocalKeyFrames/UpdateLocalPoints,
    # Tracking.cc:3478) instead of the whole landmark set. Reference
    # behavior; also what makes a drifted revisit go through loop closure
    # instead of silently re-binding. False = whole-map search (more
    # robust to large drift, non-reference).
    local_map_tracking: bool = True
    # keep inserting keyframes while RECENTLY_LOST on an inertial rig
    # (IMU dead-reckoning bridges the gap until relocalization/merge) —
    # reference mInsertKFsLost (Settings.cc:427 IMU.InsertKFsWhenLost,
    # consumed Tracking.cc:2304)
    insert_kfs_when_lost: bool = True


@dataclass
class BAConfig:
    window_size: int = 8              # optimizable KFs in local BA
    n_fixed: int = 2                  # fixed anchor KFs
    max_points: int = 4096            # landmark capacity per local BA solve
    n_iters: int = 10
    # LocalInertialBA bias structure: True (default) = per-KF bias vertices
    # + RW edges, the reference's exact structure (Optimizer.cc:2405) at
    # 15C params; False = shared window bias (9C+6 params, ~40% smaller
    # solve). Measured on a ground-truthed window with a ramping gyro bias
    # (tests/test_vi_ba.py::TestPerKFBias): shared 0.0167 m mean pose error
    # vs per-KF 0.0038 m (4.4x) — sharing only matches when the bias is
    # constant across the window.
    per_kf_bias: bool = True


@dataclass
class MappingConfig:
    # LocalMapping neighbor windows (LocalMapping.cc: CreateNewMapPoints
    # nn=10 covisible neighbors :394; SearchInNeighbors fuse :726;
    # KeyFrameCulling :914)
    n_tri_neighbors: int = 10         # triangulation partners per new KF
    n_fuse_neighbors: int = 3         # reverse-fuse targets per new KF
    kf_culling: bool = True           # enable >=90%-redundancy culling
    covis_ba_window: bool = True      # covisibility-selected local-BA window
    # run the post-loop global BA on its own thread (mpThreadGBA,
    # LoopClosing.cc:1198) instead of inline in the mapping call; the result
    # is folded back in with spanning-tree propagation for keyframes created
    # while it ran (RunGlobalBundleAdjustment tail, LoopClosing.cc:1240+)
    async_gba: bool = False
    # LocalMapping and LoopClosing on a thread of their own, the tracker
    # handing each keyframe over (System.cc:169-191): what `System` starts
    # unless its `background_mapping` says otherwise (the port's own field)
    mapper_thread: bool = False


@dataclass
class MapConfig:
    max_kf: int = 256
    max_mp: int = 16384
    # pre-trained BoW vocabulary (.npz from models/vocabulary.py). None =
    # the shipped default (data/orb_vocab.npz) if present, else a small
    # first-frame auto-trained fallback. The reference loads a pre-trained
    # binary vocabulary at startup (CustomVocabulary.h:60, System.cc:126).
    vocabulary_path: Optional[str] = None


@dataclass
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    camera2: Optional[CameraConfig] = None   # right camera (fisheye path);
                                             # None = same as camera
    stereo: StereoConfig = field(default_factory=StereoConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    map: MapConfig = field(default_factory=MapConfig)
    use_imu: bool = False

    @property
    def stereo_extrinsics(self):
        """(R_lr, t_lr) as float32 arrays (right-cam pose in left frame)."""
        R = np.eye(3, dtype=np.float32) if self.stereo.R_lr is None else \
            np.asarray(self.stereo.R_lr, np.float32).reshape(3, 3)
        t = np.asarray([self.stereo.baseline, 0.0, 0.0], np.float32) \
            if self.stereo.t_lr is None else \
            np.asarray(self.stereo.t_lr, np.float32)
        return R, t

    @property
    def bf(self) -> float:
        return self.camera.fx * self.stereo.baseline


def from_yaml(path: str) -> SlamConfig:
    """Load an ORB-SLAM3-style YAML (File.version 1.0 key naming,
    Settings.cc:144-177). Minimal parser: `Key.sub: value` lines plus
    cv::FileStorage `!!opencv-matrix` blocks (rows/cols/data) as used by the
    EuRoC/TUM-VI configs for Stereo.T_c1_c2 and IMU.T_b_c1."""
    import re
    vals = {}
    text = open(path).read()
    # opencv-matrix blocks: Key: !!opencv-matrix ... data: [ ... ]
    for mname, data in re.findall(
            r"([\w.]+):\s*!!opencv-matrix.*?data:\s*\[([^\]]*)\]",
            text, flags=re.S):
        vals[mname] = np.asarray(
            [float(x) for x in re.split(r"[,\s]+", data.strip()) if x],
            np.float64)
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if ":" not in line or "!!opencv-matrix" in line:
            continue
        k, v = line.split(":", 1)
        k, v = k.strip().strip('"'), v.strip().strip('"')
        if k in vals or not k or not v:
            continue
        try:
            vals[k] = float(v)
        except ValueError:
            vals[k] = v

    cfg = SlamConfig()
    cam_type = str(vals.get("Camera.type", vals.get("Camera1.type", "PinHole")))
    cfg.camera.model = "kannala_brandt8" if "Kannala" in cam_type else "pinhole"
    for name, attr in [("fx", "fx"), ("fy", "fy"), ("cx", "cx"), ("cy", "cy")]:
        for prefix in ("Camera1", "Camera"):
            key = f"{prefix}.{name}"
            if key in vals:
                setattr(cfg.camera, attr, float(vals[key]))
                break
    k = [float(vals.get(f"Camera1.k{i}", vals.get(f"Camera.k{i}", 0.0)))
         for i in (1, 2, 3, 4)]
    cfg.camera.k = tuple(k)
    if cfg.camera.model == "pinhole":
        # pinhole distortion: Camera1.k1/k2/p1/p2[/k3] (EuRoC-style configs)
        cfg.camera.dist = tuple(
            float(vals.get(f"Camera1.{n}", vals.get(f"Camera.{n}", 0.0)))
            for n in ("k1", "k2", "p1", "p2", "k3"))
    # second camera (fisheye two-camera rigs: EuRoC/TUM-VI KB8 configs)
    if "Camera2.fx" in vals:
        cfg.camera2 = CameraConfig(
            model=cfg.camera.model,
            fx=float(vals["Camera2.fx"]), fy=float(vals["Camera2.fy"]),
            cx=float(vals["Camera2.cx"]), cy=float(vals["Camera2.cy"]),
            k=tuple(float(vals.get(f"Camera2.k{i}", 0.0)) for i in (1, 2, 3, 4)),
            dist=tuple(float(vals.get(f"Camera2.{n}", 0.0))
                       for n in ("k1", "k2", "p1", "p2", "k3")),
            width=cfg.camera.width, height=cfg.camera.height)
        if cfg.camera.model == "kannala_brandt8":
            cfg.stereo.fisheye = True
        elif cfg.camera.has_dist or cfg.camera2.has_dist:
            # raw distorted stereo pinhole rig (EuRoC): the engine must
            # rectify before row-banded stereo matching (Settings.cc:177)
            cfg.stereo.rectify = True
    # stereo extrinsic T_c1_c2 (pose of cam2 in cam1 — our R_lr/t_lr)
    for key in ("Stereo.T_c1_c2", "Tlr"):
        if key in vals and np.size(vals[key]) >= 12:
            T = np.asarray(vals[key], np.float64).reshape(-1)[:16]
            T = T.reshape(4, 4) if T.size == 16 else \
                np.vstack([T[:12].reshape(3, 4), [0, 0, 0, 1]])
            cfg.stereo.R_lr = tuple(T[:3, :3].reshape(-1).tolist())
            cfg.stereo.t_lr = tuple(T[:3, 3].tolist())
            cfg.stereo.baseline = float(np.linalg.norm(T[:3, 3]))
            break
    # IMU-from-camera extrinsic
    if "IMU.T_b_c1" in vals and np.size(vals["IMU.T_b_c1"]) >= 12:
        T = np.asarray(vals["IMU.T_b_c1"], np.float64).reshape(-1)
        T = T[:16].reshape(4, 4) if T.size >= 16 else \
            np.vstack([T[:12].reshape(3, 4), [0, 0, 0, 1]])
        cfg.imu.R_bc = tuple(T[:3, :3].reshape(-1).tolist())
        cfg.imu.t_bc = tuple(T[:3, 3].tolist())
    if "Camera.width" in vals:
        cfg.camera.width = int(vals["Camera.width"])
    if "Camera.height" in vals:
        cfg.camera.height = int(vals["Camera.height"])
    if "Camera.bf" in vals and cfg.camera.fx:
        cfg.stereo.baseline = float(vals["Camera.bf"]) / cfg.camera.fx
    if "ThDepth" in vals:
        cfg.stereo.depth_factor = float(vals["ThDepth"])
    if "ORBextractor.nFeatures" in vals:
        cfg.orb.max_kp = int(vals["ORBextractor.nFeatures"])
    if "ORBextractor.nLevels" in vals:
        cfg.orb.n_levels = int(vals["ORBextractor.nLevels"])
    if "ORBextractor.iniThFAST" in vals:
        cfg.orb.fast_threshold = float(vals["ORBextractor.iniThFAST"])
    for yk, attr in [("IMU.NoiseGyro", "noise_gyro"), ("IMU.NoiseAcc", "noise_acc"),
                     ("IMU.GyroWalk", "walk_gyro"), ("IMU.AccWalk", "walk_acc"),
                     ("IMU.Frequency", "freq")]:
        if yk in vals:
            setattr(cfg.imu, attr, float(vals[yk]))
    # runtime flags (System.cc:174-184; Settings.cc:427)
    if "thFarPoints" in vals:
        cfg.tracker.th_far_points = float(vals["thFarPoints"])
    if "System.thFarPoints" in vals:
        cfg.tracker.th_far_points = float(vals["System.thFarPoints"])
    if "IMU.InsertKFsWhenLost" in vals:
        cfg.tracker.insert_kfs_when_lost = bool(int(vals["IMU.InsertKFsWhenLost"]))
    return cfg
