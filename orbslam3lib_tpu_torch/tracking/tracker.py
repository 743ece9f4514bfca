"""Synchronous stereo SLAM (port of the synchronous stereo path of
`orbslam3lib_tpu/tracking/tracker.py`, the reference's `Tracker(cfg,
"stereo", enable_loop_closing=..., pipeline=0)`).

Per frame (`Tracker.process_frame`, reference :765-874): stereo ORB
extraction (kernel 1 on every pyramid level, both eyes in one launch),
rectified stereo matching + SAD refinement; then either stereo
initialisation (first frame; its keyframe enters the BoW database) or the
two-stage projection search + pose LM against the map, with the
TrackReferenceKeyFrame fallback (kernel 2) when the inliers fall short;
then the keyframe decision and, on a keyframe, insertion with stereo
landmark spawning and the per-keyframe back end (`_mapping_pipeline`): BoW
add + LocalMapping + the loop-candidate probe
(`mapping/loop_closing.mapper_step_fused`), then local BA over the
covisibility window, whose result refreshes the tracker's pose; then, with
loop closing on, the probe's pack is read and `LoopCloser` may verify a
candidate, correct the loop and run the global BA, all inside the
keyframe's frame (reference :1879-1927, `_consume_probes` :1017-1050).

A frame that misses its inliers twice counts a failure, enters
RECENTLY_LOST and tries BoW relocalisation against up to 3 candidate
keyframes (kernel 2 matches it to each); after 5 s lost the map is dropped
and tracking starts over (`_handle_loss`).

What this slice leaves out, each for later work: map compaction (the
landmark-pressure flag is read from the probe pack and not acted on), the
Atlas (a lost map of more than 10 keyframes is dropped, not archived, and
no map merging), mono, IMU (so no inertial dead reckoning while lost),
fisheye and rectification inputs, and the async, pipelined and
asynchronous-global-BA paths.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..device import get_device
from ..mapping import local_mapping as lm_ops
from ..mapping.loop_closing import LoopCloser, mapper_step_fused
from ..mapping.map_ba import inv_sigma2 as _inv_sigma2
from ..mapping.map_ba import map_window_ba as _local_ba
from ..models import map_state as ms
from ..models.vocabulary import (DEFAULT_VOCAB_PATH, bow_from_descriptors,
                                 load_vocabulary, train_vocabulary)
from ..ops.extractor import Features, ThresholdController, extract_orb_stereo
from ..ops.pyramid import scale_factors_on
from ..utils import cameras, lie
from . import matching
from .pose_opt import PoseObs, pose_optimization
from .reloc import (detect_reloc_candidates, make_place_recognition,
                    relocalize_against_kf, track_reference_kf)

# Tracking states (Tracking.h eTrackingState)
NOT_INITIALIZED = 0
OK = 1
RECENTLY_LOST = 2
LOST = 3


def _local_map_mask(m: ms.MapState, prev_mp: torch.Tensor) -> torch.Tensor:
    """Local-map landmark mask (TrackLocalMap's UpdateLocalKeyFrames +
    UpdateLocalPoints, Tracking.cc:3478-3560): keyframes observing the
    previous frame's tracked landmarks, plus their covisible neighbours,
    contribute their landmarks. Empty -> the whole map."""
    P = m.max_mp
    prev_ok = prev_mp >= 0
    ind = torch.zeros(P + 1, device=prev_mp.device).index_add_(
        0, torch.where(prev_ok, prev_mp, P).long(),
        torch.ones(prev_mp.shape, device=prev_mp.device))[:P]
    O = ms.observation_matrix(m)                     # (K, P)
    k1 = ((O @ ind) > 0) & m.kf_valid                # local keyframes
    covis = O @ (O.T @ k1.to(torch.float32))
    k2 = (covis > 0) & m.kf_valid
    mask = (O.T @ (k1 | k2).to(torch.float32)) > 0   # (P,) local points
    return mask | ~torch.any(mask)


def _two_stage_core(m: ms.MapState, R0, t0, feat_xy, feat_level, feat_desc,
                    feat_valid, u_right, depth, cam_params, bf: float,
                    r_coarse: float, r_fine: float, cam_model: int,
                    img_w: int, img_h: int, n_levels: int, pose_rounds: int,
                    pose_iters: int, prev_mp=None, prev_angle=None,
                    feat_angle=None, local_only: bool = False):
    """Two-stage projection search + pose optimisation against the map.

    Stage 1 (TrackWithMotionModel): with `prev_mp` (F,), the previous
    frame's tracked landmark ids, only those are searched at the coarse
    radius, pruned by the rotation-consistency histogram when both frames'
    angles are given. Stage 2 (TrackLocalMap): the (local) map at the fine
    radius.

    Returns (R, t, mp_feat (P,), inlier_per_mp (P,), n_inliers, visible (P,),
    obs, feat_tracked (F,), feat_mp_out (F,)).
    """
    F = feat_xy.shape[0]
    P = m.max_mp
    dev = feat_xy.device
    lm_mask = _local_map_mask(m, prev_mp) if local_only and prev_mp is not None else None
    obs_is2 = _inv_sigma2(feat_level, n_levels)
    u_r_obs = torch.where(depth > 0, u_right, torch.zeros_like(u_right))

    def one_stage(R, t, radius, sub_ids=None):
        if sub_ids is None:
            val = m.mp_valid if lm_mask is None else m.mp_valid & lm_mask
            pos, desc, normal = m.mp_pos, m.mp_desc, m.mp_normal
            mind, maxd = m.mp_min_dist, m.mp_max_dist
            ids, n_rows = None, P
        else:
            idc = torch.clamp(sub_ids, 0, P - 1).long()
            val = (sub_ids >= 0) & m.mp_valid[idc]
            pos, desc, normal = m.mp_pos[idc], m.mp_desc[idc], m.mp_normal[idc]
            mind, maxd = m.mp_min_dist[idc], m.mp_max_dist[idc]
            ids, n_rows = idc, sub_ids.shape[0]
        pm = matching.search_by_projection(
            pos, desc, val, normal, mind, maxd, R, t, cam_params, feat_xy,
            feat_level, feat_desc, feat_valid, radius, cam_model=cam_model,
            img_w=img_w, img_h=img_h, n_levels=n_levels)
        if sub_ids is not None and prev_angle is not None and feat_angle is not None:
            okm = pm.mp_feat >= 0
            keep = matching.rotation_consistency(
                prev_angle, feat_angle[torch.clamp(pm.mp_feat, 0, F - 1).long()], okm)
            pm = pm._replace(mp_feat=torch.where(keep, pm.mp_feat, -1))
        # invert the landmark-side match to the feature side, so the pose
        # solve runs over F observations, not the landmark capacity
        tgt = torch.where(pm.mp_feat >= 0, pm.mp_feat, F).long()
        feat_row = torch.full((F + 1,), -1, dtype=torch.int64, device=dev)
        feat_row[tgt] = torch.arange(n_rows, device=dev)
        feat_row = feat_row[:F]
        row_c = torch.clamp(feat_row, 0, n_rows - 1)
        feat_mp = torch.where(feat_row >= 0, ids[row_c] if ids is not None else row_c, -1)
        has = feat_mp >= 0
        obs = PoseObs(p_world=m.mp_pos[torch.clamp(feat_mp, 0, P - 1)],
                      uv=feat_xy, inv_sigma2=obs_is2, u_right=u_r_obs,
                      is_stereo=has & (depth > 0), valid=has)
        R2, t2, inl_f, n_inl = pose_optimization(
            R, t, obs, cam_params, cam_model=cam_model, bf=bf,
            n_rounds=pose_rounds, iters_per_round=pose_iters)
        return R2, t2, pm, feat_mp, inl_f, obs

    R1, t1, _, _, _, _ = one_stage(R0, t0, r_coarse, sub_ids=prev_mp)
    R2, t2, pm, feat_mp, inl_f, obs = one_stage(R1, t1, r_fine)
    f_of_mp = torch.clamp(pm.mp_feat, 0, F - 1).long()
    inl_mp = (pm.mp_feat >= 0) & inl_f[f_of_mp]
    mp_feat = torch.where(inl_mp, pm.mp_feat, -1)
    feat_tracked = (feat_mp >= 0) & inl_f
    feat_mp_out = torch.where(feat_tracked, feat_mp, -1).to(torch.int32)
    return (R2, t2, mp_feat, inl_mp, torch.sum((mp_feat >= 0).to(torch.int32)),
            pm.visible, obs, feat_tracked, feat_mp_out)


def _insert_kf_and_spawn(m: ms.MapState, R, t, ts: float, feat_xy, feat_level,
                         feat_desc, feat_valid, u_right, depth, mp_feat,
                         cam_params, close_depth: float, cam_model: int,
                         n_levels: int, v=None, bg=None, ba=None, angle=None,
                         img_w: int = 640, img_h: int = 400,
                         th_far: float = 0.0):
    """Insert a keyframe, bind its tracked landmarks, and spawn landmarks for
    unmatched close-stereo features (CreateNewKeyFrame, Tracking.cc:3277),
    updating `m` in place. Returns (m, kf_id), -1 when the map is full."""
    F = feat_xy.shape[0]
    P = m.max_mp
    dev = feat_xy.device
    pidx = torch.arange(P, dtype=torch.int32, device=dev)

    def invert(mp_to_feat, ok):
        # (P,) landmark -> feature slot  =>  (F,) feature -> landmark
        out = torch.full((F + 1,), -1, dtype=torch.int32, device=dev)
        out[torch.where(ok, mp_to_feat, F).long()] = pidx
        return out[:F]

    assoc = invert(mp_feat, (mp_feat >= 0) & m.mp_valid)
    # re-associate still-unmatched features against landmarks born in the
    # last 8 keyframes before spawning (the reference's dedupe at insert)
    recent = m.mp_first_kf >= m.n_kf - 8
    unassoc = feat_valid & (assoc < 0)
    bound = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    bound.index_fill_(0, torch.where(assoc >= 0, assoc, P).long(), True)
    pm = matching.search_by_projection(
        m.mp_pos, m.mp_desc, m.mp_valid & ~bound[:P] & recent, m.mp_normal,
        m.mp_min_dist, m.mp_max_dist, R, t, cam_params, feat_xy, feat_level,
        feat_desc, unassoc, radius=4.0, cam_model=cam_model, img_w=img_w,
        img_h=img_h, th_desc=matching.TH_LOW, n_levels=n_levels)
    assoc2 = invert(pm.mp_feat, pm.mp_feat >= 0)
    assoc = torch.where(assoc >= 0, assoc, assoc2)

    m, kf_id = ms.insert_keyframe(m, R, t, ts, feat_xy, feat_level, feat_desc,
                                  feat_valid, assoc, depth, v=v, bg=bg, ba=ba,
                                  angle=angle)
    if kf_id < 0:
        return m, kf_id

    # spawn stereo landmarks for unmatched features: all closer than the
    # close-depth threshold, topped up with the nearest 100 beyond it
    cand = feat_valid & (assoc < 0) & (depth > 0.05)
    d_sort = torch.where(cand, depth, torch.full_like(depth, float("inf")))
    d100 = torch.sort(d_sort).values[min(100, F) - 1]
    want = cand & ((depth < close_depth) | (depth <= d100))
    if th_far > 0:
        want = want & (depth < th_far)
    p_cam = cameras.unproject(cam_model, cam_params, feat_xy) * depth[:, None]
    Rwc, c_w = lie.se3_inverse(R, t)
    p_w = lie.se3_apply(Rwc, c_w, p_cam)
    dist = torch.linalg.norm(p_cam, dim=-1)
    normal = (p_w - c_w) / torch.clamp(dist[:, None], min=1e-9)
    sf = scale_factors_on(n_levels, dev)
    max_dist = dist * sf[torch.clamp(feat_level, 0, n_levels - 1).long()]
    min_dist = max_dist / sf[n_levels - 1]
    ms.spawn_mappoints(m, kf_id, p_w, feat_desc, normal, min_dist, max_dist,
                       want, torch.arange(F, device=dev))
    return m, kf_id


class Tracker:
    """Host-side state machine of synchronous stereo tracking.

    `device` is where the map, the frames and all per-frame work live. It
    has no default and is used exactly as given (see `device.get_device`).
    `enable_loop_closing` as in the reference (on by default).
    """

    def __init__(self, cfg: SlamConfig, sensor: str = "stereo", *,
                 device: torch.device | str, enable_loop_closing: bool = True):
        if sensor != "stereo":
            raise NotImplementedError(f"sensor {sensor!r}: only stereo is ported")
        if cfg.use_imu or cfg.stereo.fisheye or cfg.stereo.rectify \
                or cfg.camera.model_id != cameras.PINHOLE:
            raise NotImplementedError(
                "only rectified pinhole stereo without IMU is ported")
        if not cfg.mapping.covis_ba_window:
            raise NotImplementedError(
                "only the covisibility local-BA window is ported")
        if cfg.mapping.async_gba:
            raise NotImplementedError("only the synchronous global BA is ported")
        self.cfg = cfg
        self.sensor = sensor
        self.device = get_device(device)
        mc = cfg.map
        self.map = ms.empty_map(mc.max_kf, mc.max_mp, cfg.orb.max_kp,
                                device=self.device)
        self.threshold = ThresholdController(
            target=cfg.orb.target_features, band=cfg.orb.threshold_band,
            t0=cfg.orb.fast_threshold)
        self.cam_params = torch.as_tensor(cfg.camera.params, device=self.device)
        self.state = NOT_INITIALIZED
        self.pose: Optional[Tuple[torch.Tensor, torch.Tensor]] = None   # Tcw
        self.vel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.frame_state_v = torch.zeros(3, device=self.device)
        self.frame_id = 0
        self.last_kf_frame = -999
        self.last_kf_id = -1
        self.ref_kf_matches = 0
        self.n_inliers_last = 0
        self.trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.stats = {"n_kf": 0, "n_frames": 0, "track_fail": 0,
                      "ref_kf_fallbacks": 0, "n_reloc": 0, "n_loops": 0,
                      "n_resets": 0, "n_new_maps": 0,
                      "n_mapping_steps": 0, "n_local_ba": 0}
        self._th_far = (float(cfg.tracker.th_far_points)
                        if cfg.tracker.th_far_points > 0 else None)
        self.place_rec = None         # BoW keyframe database (lazy)
        self.enable_loop_closing = enable_loop_closing
        self.loop_closer = None       # made with the database
        self._mp_pressure = False     # landmark capacity nearly used (probe pack)
        self._kf_wall = 0.0           # host time of the last keyframe's creation
        self.lost_since: Optional[float] = None
        self._n_kf_host = 0           # host mirror of map.n_kf
        self._ts_origin: Optional[float] = None
        self._last_frame_ts: Optional[float] = None
        # previous frame's bindings (feature slot -> landmark id) and angles
        self._prev_feat_mp: Optional[torch.Tensor] = None
        self._prev_feat_angle: Optional[torch.Tensor] = None

    def _rel_ts(self, ts: float) -> float:
        """Map-relative timestamp for the f32 map tensors (origin: the map's
        first keyframe, kept in f64 on the host)."""
        if self._ts_origin is None:
            self._ts_origin = float(ts)
        return float(ts) - self._ts_origin

    def _eye_pose(self):
        return (torch.eye(3, dtype=torch.float32, device=self.device),
                torch.zeros(3, dtype=torch.float32, device=self.device))

    # -- per-frame entry ----------------------------------------------------
    def process_frame(self, img, ts: float) -> dict:
        """img: (2, H, W) rectified stereo pair (uint8 or float32; numpy or
        tensor). Returns {"state", "n_inliers", ...} for the frame."""
        cfg = self.cfg
        # timestamp guards (Tracking.cc:1871-1909): a backwards step resets
        # the map, a gap over 1 s starts a new one
        if self._last_frame_ts is not None and self.state != NOT_INITIALIZED:
            dt_frame = ts - self._last_frame_ts
            if dt_frame < 0.0:
                self._reset_active_map()
            elif dt_frame > 1.0:
                self._new_map()
        self._last_frame_ts = ts

        img_dev = torch.as_tensor(img, device=self.device)
        if img_dev.dim() != 3 or img_dev.shape[0] != 2:
            raise ValueError(f"expected a (2, H, W) stereo pair, got {tuple(img_dev.shape)}")
        feats, canvas = extract_orb_stereo(
            img_dev, float(np.float32(self.threshold.t)),
            max_kp=cfg.orb.max_kp, n_levels=cfg.orb.n_levels,
            return_canvas=True)
        bf, min_z = float(cfg.bf), float(cfg.stereo.min_z)
        u_r, depth = matching.match_rectified_stereo(
            feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
            feats.xy[1], feats.level[1], feats.desc[1], feats.valid[1],
            bf, min_z, n_levels=cfg.orb.n_levels)
        if cfg.stereo.sad_refine:
            u_r, depth = matching.refine_stereo_sad(
                canvas[0], canvas[1], feats.xy[0], feats.level[0],
                feats.valid[0], u_r, depth, bf=bf, min_z=min_z,
                n_levels=cfg.orb.n_levels)
        n_feat = int(feats.n_valid[0])
        self.threshold.update(n_feat)

        if self.state == NOT_INITIALIZED:
            out = self._initialize_stereo(feats, u_r, depth, ts, n_feat)
        else:
            out = self._track(feats, u_r, depth, ts)

        self.frame_id += 1
        self.stats["n_frames"] += 1
        if self.pose is not None:
            R, t = self.pose
            self.trajectory.append((ts, R.cpu().numpy(), t.cpu().numpy()))
        return out

    # -- initialisation -------------------------------------------------------
    def _initialize_stereo(self, feats: Features, u_r, depth, ts, n_feat) -> dict:
        cfg = self.cfg
        # init gate scaled to the regulated feature budget (the reference's
        # 500 assumes ~1000 features)
        gate = min(cfg.tracker.min_init_features,
                   max(50, round(0.5 * cfg.orb.target_features)))
        if n_feat < gate:
            return {"state": self.state, "n_inliers": 0}
        R, t = self._eye_pose()
        mp_feat0 = torch.full((self.map.max_mp,), -1, dtype=torch.int32,
                              device=self.device)
        # StereoInitialization (Tracking.cc:2391): every positive-depth
        # feature becomes a landmark
        self.map, kf_id = _insert_kf_and_spawn(
            self.map, R, t, self._rel_ts(ts), feats.xy[0], feats.level[0],
            feats.desc[0], feats.valid[0], u_r, depth, mp_feat0,
            self.cam_params, 1e9, cam_model=cfg.camera.model_id,
            n_levels=cfg.orb.n_levels, angle=feats.angle[0],
            img_w=cfg.camera.width, img_h=cfg.camera.height,
            th_far=cfg.tracker.th_far_points)
        n_mp = int(self.map.n_mp)
        self._n_kf_host = int(self.map.n_kf)
        if self.pose is None:
            self.pose = self._eye_pose()
        self.vel = self._eye_pose()
        self.state = OK
        self.last_kf_frame = self.frame_id
        self.last_kf_id = int(kf_id)
        self.ref_kf_matches = n_mp
        self.stats["n_kf"] += 1
        self.lost_since = None
        self._ensure_place_rec(feats.desc[0])
        self.place_rec.add(int(kf_id), self.map.kf_desc[int(kf_id)],
                           self.map.kf_feat_valid[int(kf_id)])
        return {"state": OK, "n_inliers": n_mp, "init": True}

    # -- per-frame tracking -------------------------------------------------
    def _track_args(self) -> dict:
        cfg = self.cfg
        return dict(
            bf=float(cfg.bf),
            r_coarse=float(cfg.tracker.match_radius_coarse),
            r_fine=float(cfg.tracker.match_radius_fine),
            cam_model=cfg.camera.model_id, img_w=cfg.camera.width,
            img_h=cfg.camera.height, n_levels=cfg.orb.n_levels,
            pose_rounds=cfg.tracker.pose_rounds,
            pose_iters=cfg.tracker.pose_iters)

    def _track(self, feats: Features, u_r, depth, ts) -> dict:
        cfg = self.cfg
        R_last, t_last = self.pose
        Rv, tv = self.vel
        R0, t0 = lie.se3_compose(Rv, tv, R_last, t_last)
        f0 = (feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0])

        # previous frame's bindings drive the stage-1 restriction and the
        # local map (None right after init: both stages search the map)
        local = bool(cfg.tracker.local_map_tracking)
        prev = self._prev_feat_mp if local else None
        (R, t, mp_feat, _, n_inl, visible, _, _, feat_mp_out) = _two_stage_core(
            self.map, R0, t0, *f0, u_r, depth, self.cam_params,
            prev_mp=prev, prev_angle=self._prev_feat_angle if prev is not None else None,
            feat_angle=feats.angle[0] if prev is not None else None,
            local_only=local, **self._track_args())
        n_inliers = int(n_inl)
        # MapPoint::IncreaseVisible/IncreaseFound, in place
        self.map.mp_visible += visible
        self.map.mp_found += (mp_feat >= 0).to(torch.float32)

        # finite-difference velocity (kept with each keyframe, kf_v)
        _, p_w = lie.se3_inverse(R, t)
        _, p_l = lie.se3_inverse(R_last, t_last)
        dt_f = max(ts - (self.trajectory[-1][0] if self.trajectory else ts - 0.05), 1e-3)
        self.frame_state_v = (p_w - p_l) / dt_f

        min_inl = cfg.tracker.min_inliers
        if n_inliers < min_inl and self.last_kf_id >= 0:
            # TrackReferenceKeyFrame fallback (Tracking.cc:2778): re-seed from
            # the reference keyframe's landmarks (kernel 2 on the card), then
            # re-run the two-stage track from the recovered pose
            self.stats["ref_kf_fallbacks"] += 1
            R_ref, t_ref, n_ref = track_reference_kf(
                self.map, self.last_kf_id, R_last, t_last, *f0,
                feats.angle[0], u_r, depth, self.cam_params,
                cam_model=cfg.camera.model_id, bf=float(cfg.bf),
                n_levels=cfg.orb.n_levels)
            if int(n_ref) >= min_inl:
                (R, t, mp_feat, _, n_inl, visible, _, _, feat_mp_out) = \
                    _two_stage_core(self.map, R_ref, t_ref, *f0, u_r, depth,
                                    self.cam_params, **self._track_args())
                n_inliers = int(n_inl)
        if n_inliers < min_inl:
            return self._handle_loss(feats, ts)

        self.state = OK
        self.lost_since = None
        Ri, ti = lie.se3_inverse(R_last, t_last)
        self.vel = lie.se3_compose(R, t, Ri, ti)
        self.pose = (R, t)
        self.n_inliers_last = n_inliers
        self._prev_feat_mp = feat_mp_out
        self._prev_feat_angle = feats.angle[0]

        made_kf = False
        if self._need_new_keyframe(n_inliers, feats, mp_feat, depth):
            self._create_keyframe(feats, u_r, depth, mp_feat, ts, n_inliers)
            made_kf = True
        return {"state": OK, "n_inliers": n_inliers, "kf": made_kf}

    def _handle_loss(self, feats: Features, ts: float) -> dict:
        """Count the failure, enter RECENTLY_LOST and try BoW relocalisation
        (reference :1529-1582, Tracking.cc:2034-2076): the keyframe
        database's candidates (`detect_reloc_candidates`), culled ones
        skipped, each tried in turn (`relocalize_against_kf`); the first
        with >= 50 inliers sets the pose, resets the velocity and counts
        `n_reloc`. Otherwise the next frames keep tracking from the last
        pose. Lost for more than 5 s, the map is given up (reference
        :1600-1605): `_new_map`, also for a map of 10 keyframes or fewer,
        where the reference only resets the tracking state and keeps the
        stale map for the next initialisation; ORB-SLAM3 resets the active
        map there."""
        cfg = self.cfg
        self.stats["track_fail"] += 1
        self._prev_feat_mp = None
        if self.state == OK:
            self.state = RECENTLY_LOST
            self.lost_since = ts
        pr = self.place_rec
        if pr is not None:
            q = bow_from_descriptors(pr.voc, feats.desc[0], feats.valid[0])
            ids, _ = detect_reloc_candidates(self.map, pr.bow_db, pr.active, q)
            kf_valid = self.map.kf_valid.cpu().numpy()
            for k in ids.cpu().numpy().tolist():
                # culled keyframes carry stale poses (KeyFrameDatabase::erase)
                if k < 0 or not kf_valid[k]:
                    continue
                R, t, n_inl = relocalize_against_kf(
                    self.map, k, feats.xy[0], feats.level[0], feats.desc[0],
                    feats.valid[0], feats.angle[0], self.cam_params,
                    cam_model=cfg.camera.model_id, img_w=cfg.camera.width,
                    img_h=cfg.camera.height, n_levels=cfg.orb.n_levels)
                n_rel = int(n_inl)
                if n_rel >= 50:                # nGood >= 50 after the refine
                    self.pose = (R, t)
                    self.vel = self._eye_pose()
                    self.state = OK
                    self.lost_since = None
                    self.stats["n_reloc"] += 1
                    return {"state": OK, "n_inliers": n_rel, "reloc": True}
        if self.lost_since is not None and ts - self.lost_since > 5.0:
            self._new_map()
        return {"state": self.state, "n_inliers": 0}

    def _new_map(self):
        """CreateMapInAtlas for a map of more than 10 keyframes, counted in
        `n_new_maps`: without the Atlas the old map is dropped, not archived.
        A smaller map is reset (ResetActiveMap)."""
        if self._n_kf_host > 10:
            self.stats["n_new_maps"] += 1
            self._clear_map()
        else:
            self._reset_active_map()

    def _reset_active_map(self):
        """ResetActiveMap: an empty map and NOT_INITIALIZED."""
        self.stats["n_resets"] += 1
        self._clear_map()

    def _clear_map(self):
        """An empty map, an empty keyframe database, NOT_INITIALIZED."""
        mc = self.cfg.map
        self.map = ms.empty_map(mc.max_kf, mc.max_mp, self.cfg.orb.max_kp,
                                device=self.device)
        if self.place_rec is not None:
            self.place_rec = make_place_recognition(self.place_rec.voc, mc.max_kf)
            if self.loop_closer is not None:
                n_loops = self.loop_closer.n_loops
                self.loop_closer = LoopCloser(self.cfg, self.place_rec, fix_scale=True)
                self.loop_closer.n_loops = n_loops
        self.state = NOT_INITIALIZED
        self.pose = None
        self.lost_since = None
        self._n_kf_host = 0
        self.last_kf_id = -1
        self.last_kf_frame = -999
        self.ref_kf_matches = 0
        self._ts_origin = None
        self._prev_feat_mp = None
        self._prev_feat_angle = None

    # -- keyframe policy (NeedNewKeyFrame, Tracking.cc:3125) ----------------
    def _need_new_keyframe(self, n_inliers, feats: Features, mp_feat, depth) -> bool:
        cfg = self.cfg
        if self._n_kf_host >= self.map.max_kf - 1:
            return False
        close_th = cfg.stereo.depth_factor * cfg.stereo.baseline
        f_of_mp = mp_feat.cpu().numpy()
        tracked_slots = np.unique(f_of_mp[f_of_mp >= 0])
        d = depth.cpu().numpy()
        valid = feats.valid[0].cpu().numpy()
        close = valid & (d > 0.05) & (d < close_th)
        tracked_mask = np.zeros_like(valid)
        tracked_mask[tracked_slots] = True
        return self._need_new_keyframe_scalars(
            n_inliers, int((close & tracked_mask).sum()),
            int((close & ~tracked_mask).sum()), self.frame_id)

    def _need_new_keyframe_scalars(self, n_inliers, n_close_tracked,
                                   n_close_untracked, frame_id) -> bool:
        """NeedNewKeyFrame from pre-reduced scalars; the mapper is always
        idle in the synchronous slice."""
        cfg = self.cfg
        if self._n_kf_host >= self.map.max_kf - 1:
            return False
        frames_since = frame_id - self.last_kf_frame
        c1a = frames_since >= cfg.tracker.max_frames_between_kf
        c1b = frames_since >= max(cfg.tracker.min_frames_between_kf, 1)
        c1c = (n_close_tracked < cfg.tracker.close_tracked_th
               and n_close_untracked > cfg.tracker.close_untracked_th)
        c2 = (n_inliers < cfg.tracker.kf_ref_ratio * max(self.ref_kf_matches, 1)
              and n_inliers > 15)
        return bool(((c1a or c1b or c1c) and c2) or (c1c and c1b))

    def _create_keyframe(self, feats: Features, u_r, depth, mp_feat, ts,
                         n_inliers):
        cfg = self.cfg
        R, t = self.pose
        zeros3 = torch.zeros(3, dtype=torch.float32, device=self.device)
        self.map, kf_id = _insert_kf_and_spawn(
            self.map, R, t, self._rel_ts(ts), feats.xy[0], feats.level[0],
            feats.desc[0], feats.valid[0], u_r, depth, mp_feat,
            self.cam_params, float(cfg.stereo.depth_factor * cfg.stereo.baseline),
            cam_model=cfg.camera.model_id, n_levels=cfg.orb.n_levels,
            v=self.frame_state_v, bg=zeros3, ba=zeros3, angle=feats.angle[0],
            img_w=cfg.camera.width, img_h=cfg.camera.height,
            th_far=cfg.tracker.th_far_points)
        self.last_kf_frame = self.frame_id
        self.last_kf_id = int(kf_id)
        self.ref_kf_matches = max(n_inliers, 1)
        self.stats["n_kf"] += 1
        self._kf_wall = time.perf_counter()
        if kf_id >= 0:
            self._n_kf_host = kf_id + 1
            self._mapping_pipeline(kf_id)

    # -- the per-keyframe back end ------------------------------------------
    def _ensure_place_rec(self, desc_bits):
        """Load the vocabulary (cfg.map.vocabulary_path, else the shipped
        one) and make the keyframe database; without a vocabulary file,
        train a small one from the first frame's descriptors, as the
        reference does (tracker.py:714-737)."""
        if self.place_rec is not None:
            return
        path = self.cfg.map.vocabulary_path or DEFAULT_VOCAB_PATH
        if os.path.exists(path):
            voc = load_vocabulary(path, device=self.device)
        else:
            d = desc_bits.cpu().numpy()
            extra = np.random.default_rng(0).integers(0, 2, size=(2048, 256)).astype(np.int8)
            voc = train_vocabulary(np.concatenate([d, extra]), k=8, depth=3).to(self.device)
        self.place_rec = make_place_recognition(voc, self.cfg.map.max_kf)
        if self.enable_loop_closing:
            # stereo: depth fixes the scale (reference :655-657)
            self.loop_closer = LoopCloser(self.cfg, self.place_rec, fix_scale=True)

    def _mapping_pipeline(self, kid: int):
        """Per-keyframe mapping, synchronous (reference :1859-1927, the fused
        branch): BoW add + cull / triangulate / fuse / keyframe culling +
        the loop probe as one queue of device work, then local BA; then,
        when the keyframe passes the probe gates, the probe pack is read and
        consumed (`_consume_probe`). The probe runs whenever a loop closer
        exists, as in the reference."""
        cfg = self.cfg
        pr = self.place_rec
        voc = pr.voc
        lc = self.loop_closer
        want_probe = lc is not None and lc.probe_gates_ok(kid, self._n_kf_host)
        dev = self.device
        self.map, pr.bow_db, pr.active, probe = mapper_step_fused(
            self.map, pr.bow_db, pr.active, voc.centroids, voc.idf,
            torch.full((), kid, dtype=torch.int32, device=dev),
            self.cam_params, k=voc.k, depth=voc.depth,
            cam_model=cfg.camera.model_id, img_w=cfg.camera.width,
            img_h=cfg.camera.height, n_levels=cfg.orb.n_levels,
            n_tri=cfg.mapping.n_tri_neighbors, n_fuse=cfg.mapping.n_fuse_neighbors,
            do_cull_kf=bool(cfg.mapping.kf_culling), with_probe=lc is not None,
            th_far=self._th_far,
            prev_cand=torch.full((), lc.consistent_candidate if lc is not None else -1,
                                 dtype=torch.int32, device=dev))
        self.stats["n_mapping_steps"] += 1
        self._run_local_ba(kid)
        if want_probe:
            self._consume_probe(kid, probe.cpu().numpy())

    def _consume_probe(self, kid: int, pv: np.ndarray):
        """The loop closer on a read probe pack (reference
        `_consume_probes`): landmark pressure from the pack's n_mp slot
        (for map compaction, which is not ported: nothing acts on it yet),
        then the consistency machine, verification, correction and global
        BA; after a loop, `n_loops`, `loop_latency_ms` (keyframe creation
        to corrected map, host clock) and the pose from the corrected
        keyframe."""
        if pv[11] > 0:
            self._mp_pressure = bool(pv[11] >= 0.9 * self.map.max_mp)
        lc = self.loop_closer
        n_before = lc.n_loops
        self.map = lc.on_probe_result(self.map, kid, pv, self.cam_params)
        if lc.n_loops > n_before:
            self.stats["n_loops"] += 1
            self.stats["loop_latency_ms"] = round(
                (time.perf_counter() - self._kf_wall) * 1e3, 1)
            self.pose = (self.map.kf_R[kid].clone(), self.map.kf_t[kid].clone())

    def _run_local_ba(self, kf_id: int):
        """Local BA over the covisibility window, its oldest members fixed
        (reference :2197-2225), from the third keyframe on; the tracker's
        pose becomes the keyframe's optimised one."""
        cfg = self.cfg
        if self._n_kf_host < 3:
            return
        ids, fixed = lm_ops.covis_ba_window(
            self.map, torch.full((), kf_id, dtype=torch.int32, device=self.device),
            n_win=cfg.ba.window_size, n_fixed=cfg.ba.n_fixed)
        self.map = _local_ba(self.map, ids, fixed, self.cam_params, float(cfg.bf),
                             cam_model=cfg.camera.model_id,
                             n_ba_points=cfg.ba.max_points, n_iters=cfg.ba.n_iters)
        self.stats["n_local_ba"] += 1
        # copies: the map's rows change in place at the next keyframe
        self.pose = (self.map.kf_R[kf_id].clone(), self.map.kf_t[kf_id].clone())

    def trajectory_centers(self) -> np.ndarray:
        """(T, 3) camera centres of the tracked frames."""
        out = [-R.T @ t for _, R, t in self.trajectory]
        return np.stack(out) if out else np.zeros((0, 3))
