"""Visual SLAM (port of the visual paths of
`orbslam3lib_tpu/tracking/tracker.py`): the synchronous tracker for the
stereo, monocular and RGB-D sensors, the pipelined stereo tracker of
bench.py's `full_slam` mode (`pipeline`, `chunk`), the background mapper
thread (`async_mapping`) and the asynchronous global BA
(`cfg.mapping.async_gba`).

Three stereo rigs are ported: rectified pinhole stereo; raw distorted
stereo with `cfg.stereo.rectify` (radial-tangential or KB8 eyes, rectified
on the card every frame through maps built once in `__init__`, after which
the effective camera is the shared rectified pinhole, reference :486-516);
and two-camera Kannala-Brandt stereo with `cfg.stereo.fisheye`
(`matching.match_fisheye_stereo`, the rig the reference was built for).

Per frame (`Tracker.process_frame`, reference :765-874): map compaction
when the keyframe slots or the landmark slots run short (`_compact_map`,
with a 64-frame backoff after a compaction that frees nothing); the remap
of a raw pair; stereo ORB extraction (kernel 1 on every pyramid level, both
eyes in one launch); rectified stereo matching + SAD refinement, or the
fisheye matcher; then either stereo
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

The pipelined path (`pipeline > 1`, steady-state tracking only; reference
:884-1281): frames are buffered into chunks of `chunk` and each chunk runs
`_frame_step_chunk` against a map that is read-only for the chunk, with the
local-map mask computed once per chunk; nothing in a chunk reads the card.
Each chunk's 16-float packs (and the loop probes waiting since the last
chunk) are copied into a pinned host buffer with an event recorded after
the copy; the host consumes a chunk when its event has fired, or blocks on
the oldest once more than `pipeline` frames are in flight. The consumer
runs the keyframe policy per frame, one threshold-controller step per
batch, and creates keyframes whose mapping runs inline or on the mapper
thread; there the loop probe is only dispatched and rides the next chunk's
read (lagged loops). A loss inside a burst drops every frame in flight and
returns to the synchronous path.

Threads (reference :1747-1857): with `async_mapping` one mapper thread
takes keyframe ids from a queue and runs `_mapping_pipeline` under
`_map_lock` (the reference's Map::mMutexMapUpdate); with
`cfg.mapping.async_gba` a loop correction starts the global BA on a thread
of its own, on a snapshot of the map, merged back by `merge_gba_result`.
Every thread that touches the card runs on the tracker's card and on its
one stream, so the card runs work in the order the threads enqueue it. The
mapper thread survives an exception and counts it in
`stats["mapper_errors"]` (the GBA thread in `stats["gba_errors"]`).

Two faults of the reference's asynchronous code are not carried over:
its pipelined keyframe (`_create_keyframe_from_record`, :1259-1261) aborts
the dedicated GBA thread, whose comment (:1737-1740) says only a newer loop
should; here only a newer loop, a compaction or a map reset does. And its
`merge_gba_result` picks the landmarks the GBA optimised by a slot count
(see `mapping/map_ba.merge_gba_result`). A drain dispatches only the
buffered frames: the reference pads a short chunk by repeating its last
frame (a static shape for `lax.scan`), which counts that frame's landmark
visibility twice.

A frame that misses its inliers twice counts a failure, enters
RECENTLY_LOST and tries BoW relocalisation against up to 3 candidate
keyframes (kernel 2 matches it to each); after 5 s lost, or at a gap of
over 1 s in the stamps, the map is given up (`_new_map`).

The Atlas (reference :522, :1637-1658, :1961-1990): the tracker's maps live
in `self.atlas` and `self.map` is its current one. A map given up with more
than 10 keyframes is archived (`_spawn_new_map`): its live BoW database goes
frozen to the map merger and a new map starts; a smaller one is reset. At
the end of every keyframe's back end the merger queries the archives
(`_detect_merge`, `mapping/loop_closing.MapMerger`); a verified hit welds
the archived map into the current one. Three places where threads, the
pipelined chain and compaction meet the Atlas, each held by a test in
tests/test_torch_map_merge.py:
- the mapper thread runs the merge under `_map_lock`, and a spawn takes the
  same lock and starts a new map epoch, so keyframe ids of the archived map
  still queued are skipped and nothing writes into the archived database;
- the pipelined chain and the chunks in flight are kept through a merge
  (the merge moves neither the current map's world nor its landmark slots
  nor the tracker's last keyframe: see `_detect_merge`);
- a compaction touches the current map alone, and the merger's archives
  name their maps by Atlas index, which only a merge changes (the merger
  counts the later archives down then), so they stay right after either.

Monocular (`sensor="mono"`, reference :1295-1378): frames are one image,
extracted as a batch of one (kernel 1 in one launch); there is no depth, so
tracking runs on monocular observations only, a keyframe spawns no
landmark (local mapping triangulates them) and its policy has no
close-point condition; initialisation is two-view (`_initialize_mono`,
`mapping/twoview.py`), its map scaled to median depth 1
(`scene_median_depth`; the reference leaves it unscaled, ROADMAP queue 3),
and a loop is closed with a free-scale Sim(3) whose scale the correction
gives the landmarks too. RGB-D (`sensor="rgbd"`, the reference's
`System._process_rgbd`): one image and a depth map per frame; the depth is
read at the keypoints on the card and turned into virtual right
coordinates, and the stereo tracker runs on them. Both run synchronously
(the pipelined path is stereo's) and through the same per-frame preamble
as stereo (timestamp guards, compaction, the map lock), which the
reference's RGB-D path skips (ROADMAP queue 3).

Inertial (`cfg.use_imu` on the stereo or the monocular sensor, reference
:740-775, :1397-1470, :1514-1519, :1583-1599, :1685-1690, :1990-2316):
`feed_imu` preintegrates the samples since the last frame into the frame's
and the keyframe's preintegrations at once (`tracking/imu.integrate`, a
batch of two); until the IMU is initialised the tracker inserts a keyframe
every 0.25 s, then every 0.5 s. Each keyframe gap's preintegration is kept
(`_note_kf_imu`); after 6 gaps and 1 s `_initialize_imu` estimates gravity,
the biases and (monocular) the scale (`inertial_opt.inertial_init_
optimization`), turns the map into the gravity frame and switches the loop
closer and the map merger to their inertial forms. From then on a frame's
pose is predicted by the IMU and refined by the visual-inertial solve
against the last keyframe or, chained through the marginal prior, the last
frame; every keyframe runs the windowed VI-BA (`mapping/vi_ba.py`) after
its visual back end, with the full-chain VIBA1 (5 s after initialisation)
and VIBA2 (15 s), and a monocular map's scale refined every 10 s from 25 s.
While RECENTLY_LOST the pose is dead-reckoned on the IMU and keyframes keep
coming every 0.25 s (`cfg.tracker.insert_kfs_when_lost`). Too little motion
during the initialisation phase flags the IMU bad, and the next frame
resets the map. The pipelined path does not run with an IMU (reference
:807): such a tracker runs synchronously. Nothing catches a failed inertial
solve: its state becomes the frame's.

`cfg.mapping.covis_ba_window = False` takes the fixed local-BA window
(`fixed_ba_window`) in place of the covisibility one. Configurations
outside the reference's own contract raise `NotImplementedError`
(`check_ported`): an IMU on the RGB-D sensor, mono or RGB-D on a distorted
camera, a distorted stereo rig without rectify or fisheye.
"""
from __future__ import annotations

import contextlib
import os
import queue
import sys
import threading
import time
import traceback
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig, SlamConfig
from ..device import GraphedCall, get_device, on_device, to_device, to_host
from ..mapping import local_mapping as lm_ops
from ..mapping.local_mapping import _last_write
from ..mapping.loop_closing import LoopCloser, MapMerger, mapper_step_fused
from ..mapping.map_ba import inv_sigma2 as _inv_sigma2
from ..mapping.map_ba import (global_bundle_adjust_auto, map_window_ba as _local_ba,
                              merge_gba_result)
from ..mapping.twoview import reconstruct_two_views
from ..mapping.vi_ba import apply_vi_window, local_inertial_ba
from ..models import map_state as ms
from ..models.atlas import Atlas, transform_map
from ..models.vocabulary import (DEFAULT_VOCAB_PATH, bow_from_descriptors,
                                 load_vocabulary, train_vocabulary)
from ..ops import cuda_pose
from ..ops.extractor import (Features, ThresholdController, extract_orb_mono,
                             extract_orb_stereo)
from ..ops.pyramid import scale_factors_on
from ..utils import cameras, lie, rectify
from ..utils.timing import StageTimer
from . import imu as imu_mod
from . import matching, pose_opt
from .inertial_opt import (InertialFrameState, inertial_init_optimization,
                           pose_inertial_optimization, pose_inertial_optimization_last_frame)
from .pose_opt import PoseObs, pose_optimization
from .reloc import (detect_reloc_candidates, make_place_recognition,
                    relocalize_against_kf, track_reference_kf)

# Tracking states (Tracking.h eTrackingState)
NOT_INITIALIZED = 0
OK = 1
RECENTLY_LOST = 2
LOST = 3

# stats keys: the motion-only pose solve's evaluations by the kernel and by
# the torch ops (`pose_opt`), in the order `_pose_evals` gives them
POSE_EVAL_KEYS = ("pose_evals_fused", "pose_evals_torch")


def _pose_evals():
    """The pose solve's evaluations made so far in this process, by the
    kernel and by the torch ops."""
    return cuda_pose.eval_launches, pose_opt.evals_torch


def _local_map_mask(m: ms.MapState, prev_mp: torch.Tensor,
                    ref_kf: Optional[int] = None) -> torch.Tensor:
    """Local-map landmark mask (TrackLocalMap's UpdateLocalKeyFrames +
    UpdateLocalPoints, Tracking.cc:3478-3560): keyframes observing the
    previous frame's tracked landmarks, plus their covisible neighbours,
    contribute their landmarks. With `ref_kf` (a host keyframe id, the
    pipelined chunk's last keyframe) and no bindings at all (a chain just
    re-seeded), the reference keyframe seeds the local set instead of the
    whole map (reference :80-88). Empty -> the whole map."""
    P = m.max_mp
    prev_ok = prev_mp >= 0
    ind = torch.zeros(P + 1, device=prev_mp.device).index_add_(
        0, torch.where(prev_ok, prev_mp, P).long(),
        torch.ones(prev_mp.shape, device=prev_mp.device))[:P]
    O = ms.observation_matrix(m)                     # (K, P)
    k1 = ((O @ ind) > 0) & m.kf_valid                # local keyframes
    if ref_kf is not None and ref_kf >= 0:
        ref_vec = torch.arange(m.max_kf, device=prev_mp.device) == min(ref_kf, m.max_kf - 1)
        k1 = k1 | (ref_vec & ~torch.any(prev_ok) & m.kf_valid)
    covis = O @ (O.T @ k1.to(torch.float32))
    k2 = (covis > 0) & m.kf_valid
    mask = (O.T @ (k1 | k2).to(torch.float32)) > 0   # (P,) local points
    return mask | ~torch.any(mask)


def _two_stage_core(m: ms.MapState, R0, t0, feat_xy, feat_level, feat_desc,
                    feat_valid, u_right, depth, cam_params, bf: float,
                    r_coarse: float, r_fine: float, cam_model: int,
                    img_w: int, img_h: int, n_levels: int, pose_rounds: int,
                    pose_iters: int, prev_mp=None, prev_angle=None,
                    feat_angle=None, local_only: bool = False, lm_mask=None):
    """Two-stage projection search + pose optimisation against the map.

    Stage 1 (TrackWithMotionModel): with `prev_mp` (F,), the previous
    frame's tracked landmark ids, only those are searched at the coarse
    radius, pruned by the rotation-consistency histogram when both frames'
    angles are given. Stage 2 (TrackLocalMap): the (local) map at the fine
    radius. `lm_mask` (P,) restricts stage 2 (the pipelined chunk computes
    it once); without it `local_only` computes it from `prev_mp`.

    Returns (R, t, mp_feat (P,), inlier_per_mp (P,), n_inliers, visible (P,),
    obs, feat_tracked (F,), feat_mp_out (F,)).
    """
    F = feat_xy.shape[0]
    P = m.max_mp
    dev = feat_xy.device
    if lm_mask is None and local_only and prev_mp is not None:
        lm_mask = _local_map_mask(m, prev_mp)
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
                         th_far: float = 0.0, kf_id: Optional[int] = None):
    """Insert a keyframe, bind its tracked landmarks, and spawn landmarks for
    unmatched close-stereo features (CreateNewKeyFrame, Tracking.cc:3277),
    updating `m` in place. `kf_id`: the host's mirror of n_kf, if kept (no
    read of the map's count). Returns (m, kf_id), -1 when the map is full."""
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
                                  angle=angle, kf_id=kf_id)
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


def scene_median_depth(p3d: torch.Tensor, tri_ok: torch.Tensor) -> torch.Tensor:
    """The median depth of the triangulated points (ORB-SLAM3's
    ComputeSceneMedianDepth(2): the lower median), 1 when none is; a 0-d
    tensor, no host read."""
    z = torch.where(tri_ok, p3d[:, 2], torch.full_like(p3d[:, 2], float("nan")))
    return torch.nan_to_num(torch.nanmedian(z), nan=1.0)


def _mono_init_map(m: ms.MapState, ts0: float, ts1: float, f0, f1, match_idx, tri_ok,
                   R21, t21, p3d, n_levels: int):
    """The initial monocular map (CreateInitialMapMonocular, Tracking.cc:2604;
    reference :400-444), in place: keyframe 0 at the identity with
    features f0 = (xy, level, desc, valid, angle), keyframe 1 at (R21, t21)
    with f1; landmarks at the triangulated points, bound to their features
    in both. The two-view reconstruction is scaled to median depth 1
    (`scene_median_depth`). Returns (m, keyframe 1's id, R21, t21 scaled)."""
    xy0, lvl0, desc0, fv0, ang0 = f0
    F = xy0.shape[0]
    dev = xy0.device
    inv_md = 1.0 / torch.clamp(scene_median_depth(p3d, tri_ok), min=1e-6)
    p3d_n = p3d * inv_md
    t21_n = t21 * inv_md
    no_mp = torch.full((F,), -1, dtype=torch.int32, device=dev)
    no_depth = torch.zeros(F, device=dev)
    R0 = torch.eye(3, dtype=torch.float32, device=dev)
    m, kf0 = ms.insert_keyframe(m, R0, torch.zeros(3, device=dev), ts0, xy0, lvl0, desc0,
                                fv0, no_mp, no_depth, angle=ang0)
    m, kf1 = ms.insert_keyframe(m, R21, t21_n, ts1, *f1[:4], no_mp, no_depth, angle=f1[4])
    dist = torch.linalg.norm(p3d_n, dim=-1)
    normal = p3d_n / torch.clamp(dist[:, None], min=1e-9)
    sf = scale_factors_on(n_levels, dev)
    max_dist = dist * sf[torch.clamp(lvl0, 0, n_levels - 1).long()]
    min_dist = max_dist / sf[n_levels - 1]
    ms.spawn_mappoints(m, kf0, p3d_n, desc0, normal, min_dist, max_dist, tri_ok,
                       torch.arange(F, device=dev))
    # keyframe 1's slot of each matched feature takes its landmark (the
    # last writer where two features of keyframe 0 matched the same one)
    bind = tri_ok & (match_idx >= 0)
    src = _last_write(torch.where(bind, torch.clamp(match_idx, 0, F - 1), F), F)
    new_ids = m.kf_mp[kf0][torch.clamp(src, min=0)]
    row1 = m.kf_mp[kf1]
    m.kf_mp[kf1] = torch.where((src >= 0) & (new_ids >= 0), new_ids, row1)
    return m, kf1, R21, t21_n


# the pipelined frame's scalar pack: [n_valid, n_inliers, n_close_tracked,
# n_close_untracked, R (9), t (3)] (reference :209-211)
PACK_LEN = 16


def _frame_body(m: ms.MapState, carry, img_pair, threshold: float, cam_params,
                fisheye_rig, bf: float, min_z: float, close_depth: float,
                r_coarse: float, r_fine: float, cam_model: int, img_w: int,
                img_h: int, n_levels: int, pose_rounds: int, pose_iters: int,
                max_kp: int, fisheye: bool, sad_refine: bool,
                local_only: bool = False, lm_mask=None):
    """One frame of the pipelined stereo hot path (reference :214-271):
    extraction (kernel 1) -> stereo match (+ SAD refinement), or the
    fisheye matcher -> constant-velocity prediction -> two-stage search +
    pose LM -> the velocity and the landmark-statistics updates. Reads
    nothing back to the host.

    carry = (R, t, R_vel, t_vel, prev_mp, prev_angle, mp_visible, mp_found);
    returns (carry', outs) with outs = (pack (16,), then what keyframe
    creation needs: left-eye xy, level, angle, desc, valid, u_right, depth,
    mp_feat). `fisheye_rig` = (cam2_params, R_lr, t_lr) on the fisheye rig."""
    (R_prev, t_prev, R_vel, t_vel, prev_mp, prev_angle, mp_visible, mp_found) = carry
    want_canvas = sad_refine and not fisheye
    ex = extract_orb_stereo(img_pair, threshold, max_kp=max_kp, n_levels=n_levels,
                            return_canvas=want_canvas)
    feats, canvas = ex if want_canvas else (ex, None)
    if fisheye:
        u_r, depth = matching.match_fisheye_stereo(
            feats.xy[0], feats.desc[0], feats.valid[0], feats.xy[1], feats.desc[1],
            feats.valid[1], cam_params, *fisheye_rig, bf)
    else:
        u_r, depth = matching.match_rectified_stereo(
            feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
            feats.xy[1], feats.level[1], feats.desc[1], feats.valid[1],
            bf, min_z, n_levels=n_levels)
        if want_canvas:
            u_r, depth = matching.refine_stereo_sad(
                canvas[0], canvas[1], feats.xy[0], feats.level[0], feats.valid[0],
                u_r, depth, bf=bf, min_z=min_z, n_levels=n_levels)
    R0, t0 = lie.se3_compose(R_vel, t_vel, R_prev, t_prev)
    (R, t, mp_feat, _, n_inl, visible, _, feat_tracked, feat_mp_out) = _two_stage_core(
        m, R0, t0, feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0], u_r,
        depth, cam_params, bf, r_coarse, r_fine, cam_model, img_w, img_h, n_levels,
        pose_rounds, pose_iters, prev_mp=prev_mp, prev_angle=prev_angle,
        feat_angle=feats.angle[0], local_only=local_only, lm_mask=lm_mask)
    Ri, ti = lie.se3_inverse(R_prev, t_prev)
    R_vel2, t_vel2 = lie.se3_compose(R, t, Ri, ti)
    close = feats.valid[0] & (depth > 0.05) & (depth < close_depth)
    n_close_t = torch.sum((close & feat_tracked).to(torch.float32))
    n_close_u = torch.sum((close & ~feat_tracked).to(torch.float32))
    pack = torch.cat([feats.n_valid[:1].to(torch.float32),
                      torch.stack([n_inl.to(torch.float32), n_close_t, n_close_u]),
                      R.reshape(-1), t])
    carry2 = (R, t, R_vel2, t_vel2, feat_mp_out, feats.angle[0],
              mp_visible + visible.to(torch.float32),
              mp_found + (mp_feat >= 0).to(torch.float32))
    outs = (pack, feats.xy[0], feats.level[0], feats.angle[0], feats.desc[0],
            feats.valid[0], u_r, depth, mp_feat)
    return carry2, outs


def _frame_step_chunk(m: ms.MapState, chain, imgs: List[torch.Tensor], threshold: float,
                      cam_params, fisheye_rig, local_only: bool, ref_kf: int, **kw):
    """A chunk of frames against a map that is read-only for the chunk
    (reference :278-313, whose `lax.scan` becomes a loop threading the
    carry): the local-map mask is computed once, from the chunk's entry
    bindings. chain = (R, t, R_vel, t_vel, prev_mp, prev_angle). Returns
    (chain', mp_visible', mp_found', [outs per frame])."""
    carry = tuple(chain) + (m.mp_visible, m.mp_found)
    lm_mask = _local_map_mask(m, chain[4], ref_kf=ref_kf) if local_only else None
    outs = []
    for img_pair in imgs:
        carry, o = _frame_body(m, carry, img_pair, threshold, cam_params, fisheye_rig,
                               local_only=local_only, lm_mask=lm_mask, **kw)
        outs.append(o)
    return carry[:6], carry[6], carry[7], outs


SENSORS = ("stereo", "mono", "rgbd")


def check_ported(cfg: SlamConfig, sensor: str) -> None:
    """Raise NotImplementedError for a sensor or option outside the
    reference's own contract (ValueError for an unknown sensor). `rectify`
    and `fisheye` describe a stereo rig; mono and RGB-D ignore them, as the
    reference does, and take an undistorted pinhole camera."""
    if sensor not in SENSORS:
        raise ValueError(f"unknown sensor {sensor!r}; the tracker takes {SENSORS}")
    if cfg.use_imu and sensor == "rgbd":
        raise NotImplementedError(
            "an IMU goes with the stereo or the monocular sensor (the reference "
            "has no inertial RGB-D sensor)")
    if sensor != "stereo" and cfg.camera.model_id != cameras.PINHOLE:
        # the two-view reconstruction projects through the pinhole model
        # (as the reference's, twoview.py:108), and the RGB-D virtual right
        # coordinate u - bf / z assumes undistorted pixels
        raise NotImplementedError(
            f"the {sensor} sensor takes an undistorted pinhole camera, as in the "
            "reference (its two-view reconstruction is pinhole-only)")
    if sensor == "stereo" and not (cfg.stereo.fisheye or cfg.stereo.rectify) \
            and cfg.camera.model_id != cameras.PINHOLE:
        raise NotImplementedError(
            "a distorted stereo rig needs cfg.stereo.rectify or cfg.stereo.fisheye, "
            "as in the reference (config.from_yaml sets rectify on every distorted "
            "pinhole stereo rig)")
    if sensor == "stereo" and cfg.stereo.fisheye \
            and cfg.camera.model_id != cameras.KANNALA_BRANDT:
        raise NotImplementedError(
            "the fisheye stereo path is the two-camera Kannala-Brandt rig, as in "
            "the reference")


def fixed_ba_window(n_kf: int, window_size: int, n_fixed: int):
    """The fixed local-BA window (reference :2208-2218): the last
    `window_size` keyframe slots and up to `n_fixed` anchors before them,
    keyframe 0 when none precede them (it is then in the window as well).
    Returns (ids (C,) int32, -1-padded; fixed (C,) bool) on the host, C =
    window_size + n_fixed."""
    C = window_size + n_fixed
    ids = np.full(C, -1, np.int32)
    fixed = np.zeros(C, bool)
    lo = max(0, n_kf - window_size)
    anchors = list(range(max(0, lo - n_fixed), lo)) or [0]
    sel = anchors + list(range(lo, n_kf))
    ids[:len(sel)] = sel
    fixed[:len(anchors)] = True
    return ids, fixed


def _compose_rows(packs: np.ndarray, dR: np.ndarray, dt: np.ndarray) -> None:
    """Carry frame poses (rows of 16-float packs, in place) into a moved
    world, keeping each pose relative to the keyframe whose rigid delta
    (dR, dt) this is: T' = T o (dR, dt), in float64 (reference :1130-1135)."""
    for row_v in packs:
        Rf = row_v[4:13].reshape(3, 3).astype(np.float64)
        tf = row_v[13:16].astype(np.float64)
        row_v[4:13] = (Rf @ dR).reshape(-1)
        row_v[13:16] = Rf @ dt + tf


class _Chunk:
    """One dispatched chunk of the pipelined path: its frames' stamps and
    ids, each frame's outputs (`_frame_body`), the keyframe ids of the loop
    probes riding its read, and the pinned host buffer its packs and probes
    are copied into, with the event recorded after the copy (None on the
    CPU, where the copy is done when it returns); `moves`: the rigid deltas
    of GBA merges that landed while it was in flight, on the card."""

    __slots__ = ("ts", "fids", "outs", "probe_kids", "host", "event", "moves")

    def __init__(self, ts, fids, outs, probe_kids, host, event):
        self.ts, self.fids, self.outs = ts, fids, outs
        self.probe_kids, self.host, self.event = probe_kids, host, event
        self.moves = []

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def read(self):
        """(packs (C, 16) writable, [(kid, probe (16,))]), waiting for the
        copy if it is still in flight."""
        if self.event is not None:
            self.event.synchronize()
        vec = self.host.numpy()
        C = len(self.ts)
        pack = vec[:C * PACK_LEN].reshape(C, PACK_LEN).copy()
        off = C * PACK_LEN
        return pack, [(kid, vec[off + 16 * i: off + 16 * (i + 1)])
                      for i, kid in enumerate(self.probe_kids)]


class Tracker:
    """Host-side state machine of tracking; `sensor` is "stereo", "mono" or
    "rgbd".

    `device` is where the map, the frames and all per-frame work live: the
    card by default, exactly as given otherwise (`device.get_device`, which
    raises rather than falling back to the CPU). `enable_loop_closing` as
    in the reference (on by default); `enable_timing` records the host time
    of the stages `extract`, `stereo_match` and `track` per frame
    (`self.timer`), waiting for the card at the end of each, and the spans
    of the frame's layers and of its keyframe's back end, which wait for
    nothing (`utils/timing.py`; `self.timer.export()`).

    `pipeline > 1` turns on the pipelined path with up to `pipeline` frames
    in flight, in chunks of `chunk` frames; `async_mapping` starts the
    mapper thread (stop it with `shutdown_mapping`); `cfg.mapping.async_gba`
    runs the post-loop global BA on a thread of its own. `finish()` flushes
    the pipeline and waits for both threads' work.

    With `cfg.stereo.rectify`, `__init__` changes `cfg` as the reference
    does: the camera becomes the shared rectified pinhole, the baseline the
    rectified one, `camera2`, `R_lr` and `t_lr` are cleared and `imu.R_bc`
    turns with the left eye. A second tracker needs a fresh `SlamConfig`.
    """

    PROBE_SLOTS = 8   # loop probes riding one chunk's read, at most

    def __init__(self, cfg: SlamConfig, sensor: str = "stereo", *,
                 device: torch.device | str = "cuda",
                 enable_loop_closing: bool = True, enable_timing: bool = False,
                 async_mapping: bool = False, pipeline: int = 0, chunk: int = 1):
        check_ported(cfg, sensor)
        self.cfg = cfg
        self.sensor = sensor
        self.device = get_device(device)
        self.timer = StageTimer(enabled=enable_timing, device=self.device)
        self._remap = None
        stereo = sensor == "stereo"
        if stereo and cfg.stereo.rectify and not cfg.stereo.fisheye:
            self._setup_rectification()
        self._fisheye_rig = None
        if stereo and cfg.stereo.fisheye:
            cam2 = cfg.camera2 or cfg.camera
            R_lr, t_lr = cfg.stereo_extrinsics
            self._fisheye_rig = tuple(
                torch.as_tensor(np.asarray(x, np.float32), device=self.device)
                for x in (cam2.params, R_lr, t_lr))
        mc = cfg.map
        # every map of the run; `self.map` is the current one (reference :522)
        self.atlas = Atlas(mc.max_kf, mc.max_mp, cfg.orb.max_kp, device=self.device)
        self.threshold = ThresholdController(
            target=cfg.orb.target_features, band=cfg.orb.threshold_band,
            t0=cfg.orb.fast_threshold)
        self.cam_params = torch.as_tensor(cfg.camera.params, device=self.device)
        self.state = NOT_INITIALIZED
        # Tcw and the velocity: device tensors, or f32 numpy arrays after the
        # pipelined consumer (kept on the host there; `_dev` uploads them)
        self.pose: Optional[Tuple] = None
        self.vel: Optional[Tuple] = None
        self.frame_state_v = torch.zeros(3, device=self.device)
        self.frame_id = 0
        self.last_kf_frame = -999
        self.last_kf_id = -1
        self.ref_kf_matches = 0
        self.n_inliers_last = 0
        self.trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.stats = {"n_kf": 0, "n_frames": 0, "track_fail": 0,
                      "ref_kf_fallbacks": 0, "n_reloc": 0, "n_loops": 0,
                      "n_resets": 0, "n_new_maps": 0, "n_map_merges": 0,
                      "n_mapping_steps": 0, "n_local_ba": 0, "n_compactions": 0,
                      "mapper_errors": 0, "n_gba_started": 0, "n_gba_merged": 0,
                      "n_gba_aborted": 0, "gba_errors": 0, "frames_skipped": 0,
                      "pose_evals_fused": 0, "pose_evals_torch": 0}
        self.errors: List[str] = []   # tracebacks of the threads' caught failures
        self._th_far = (float(cfg.tracker.th_far_points)
                        if cfg.tracker.th_far_points > 0 else None)
        self.place_rec = None         # BoW keyframe database (lazy)
        self.enable_loop_closing = enable_loop_closing
        self.loop_closer = None       # made with the database
        self.map_merger = None        # made with the loop closer
        self._mp_pressure = False     # landmark capacity nearly used
        self._mp_pressure_probe = None  # (n_mp copy, its event), every 8th keyframe
        self._compact_backoff = 0     # earliest frame id of the next compaction
        self._kf_wall: dict = {}      # keyframe id -> host time of its creation
        self._kf_frame: dict = {}     # keyframe id -> id of the frame that made it
        self.lost_since: Optional[float] = None
        self._n_kf_host = 0           # host mirror of map.n_kf
        self._ts_origin: Optional[float] = None
        self._last_frame_ts: Optional[float] = None
        # previous frame's bindings (feature slot -> landmark id) and angles
        self._prev_feat_mp: Optional[torch.Tensor] = None
        self._prev_feat_angle: Optional[torch.Tensor] = None
        # monocular initialisation: the first frame of the attempt (map
        # stamp, then its xy, level, desc, valid, angle) and the positions
        # its features were last matched at (mvbPrevMatched, the centres of
        # the next search windows)
        self._init_frame: Optional[tuple] = None
        self._init_prev_xy: Optional[torch.Tensor] = None
        # the inertial state (reference :561-576, :610-619): the current
        # bias estimate, the frame's velocity, the preintegrations since the
        # last frame and since the last keyframe, each keyframe gap's
        # preintegration (in order, and by destination keyframe id: (source
        # id, pre)), the keyframes' stamps and centres, the VIBA stage, the
        # anchor of the per-frame solve and the previous solve's marginal
        # prior (state, H), None right after a keyframe
        z3 = torch.zeros(3, device=self.device)
        self.imu_ready = False
        self.imu_bias = (z3, z3.clone())
        self._pre_frame: Optional[imu_mod.Preintegrated] = None
        self._pre_kf: Optional[imu_mod.Preintegrated] = None
        self._kf_preints: List[imu_mod.Preintegrated] = []
        self._kf_times: List[float] = []
        self._gap_by_dst: dict = {}
        self._prev_note_kf_id = -1
        self._kf_centers: List[np.ndarray] = []
        self._imu_init_ts: Optional[float] = None
        self._viba_stage = 0            # 1 after VIBA1, 2 after VIBA2
        self._next_scale_ref_ts: Optional[float] = None
        self.anchor_state: Optional[InertialFrameState] = None
        self._inertial_prior = None
        self._bad_imu = False
        self._tbc_dev = None
        self._integrate_pair = GraphedCall(self._flat_integrate_pair())
        self._solve_anchor = GraphedCall(self._flat_inertial_solve(False))
        self._solve_prior = GraphedCall(self._flat_inertial_solve(True))
        # the pipelined path
        self.pipeline = int(pipeline)
        self.chunk = max(1, int(chunk))
        self._img_buf: List = []      # (frame on the device, ts, frame id)
        self._pending: List[_Chunk] = []
        self._chain = None            # (R, t, R_vel, t_vel, prev_mp, prev_angle)
        self._probe_unfetched: List = []  # (kid, probe pack on the device)
        # the mapper thread and the GBA thread (reference :578-609). Queue
        # items are (map epoch, kid): a reset or a compaction starts a new
        # epoch, and the mapper skips ids of an older map
        self._map_lock = threading.RLock()
        self._map_epoch = 0
        self._map_queue: Optional[queue.Queue] = None
        self._mapper_thread: Optional[threading.Thread] = None
        self._mapper_stop = False
        self._gba_thread: Optional[threading.Thread] = None
        self._gba_abort = threading.Event()
        if async_mapping:
            self._map_queue = queue.Queue()
            self._mapper_thread = threading.Thread(target=self._mapper_loop, daemon=True)
            self._mapper_thread.start()

    @property
    def map(self) -> ms.MapState:
        return self.atlas.current_map

    @map.setter
    def map(self, m: ms.MapState):
        self.atlas.current_map = m

    def _setup_rectification(self):
        """Settings.cc:485 precomputeRectificationMaps (reference :486-516):
        Bouguet rectification of the raw rig, its two-pass maps, and the
        remap's taps on the card; then the effective camera becomes the
        shared rectified pinhole, in `cfg` itself."""
        cfg = self.cfg
        cam2 = cfg.camera2 or cfg.camera
        R_lr, t_lr = cfg.stereo_extrinsics
        rr = rectify.stereo_rectify(cfg.camera.params, cam2.params,
                                    cfg.camera.model_id, cam2.model_id,
                                    R_lr, t_lr, cfg.camera.width, cfg.camera.height)
        self._remap = rectify.TwoPassRemap(rectify.twopass_maps(rr.maps), self.device)
        fxn, fyn, cxn, cyn = [float(x) for x in rr.new_params]
        cfg.camera = CameraConfig(model="pinhole", fx=fxn, fy=fyn, cx=cxn, cy=cyn,
                                  width=cfg.camera.width, height=cfg.camera.height)
        cfg.camera2 = None
        cfg.stereo.baseline = rr.baseline
        cfg.stereo.R_lr = None
        cfg.stereo.t_lr = None
        R_bc = np.asarray(cfg.imu.R_bc, np.float64).reshape(3, 3)
        cfg.imu.R_bc = tuple((R_bc @ rr.R_rect[0].T).reshape(-1).tolist())

    @property
    def _tbc(self):
        """The IMU-from-camera extrinsic (R_bc, t_bc) on the card, made
        once (after a rectification turned R_bc)."""
        if self._tbc_dev is None:
            ci = self.cfg.imu
            self._tbc_dev = (
                to_device(np.asarray(ci.R_bc, np.float32).reshape(3, 3), self.device),
                to_device(np.asarray(ci.t_bc, np.float32), self.device))
        return self._tbc_dev

    def _rel_ts(self, ts: float) -> float:
        """Map-relative timestamp for the f32 map tensors (origin: the map's
        first keyframe, kept in f64 on the host)."""
        if self._ts_origin is None:
            self._ts_origin = float(ts)
        return float(ts) - self._ts_origin

    def _eye_pose(self):
        return (torch.eye(3, dtype=torch.float32, device=self.device),
                torch.zeros(3, dtype=torch.float32, device=self.device))

    def _dev(self, x) -> torch.Tensor:
        """A pose part on the tracker's device (the pipelined consumer keeps
        poses as host arrays; uploaded from pinned memory, no wait)."""
        if isinstance(x, torch.Tensor):
            return x
        return to_device(np.asarray(x, np.float32), self.device)

    # -- the IMU (reference :740-762) --------------------------------------
    def feed_imu(self, gyro, acc, dts):
        """The IMU samples since the previous frame (GrabImuData +
        PreintegrateIMU): (N, 3) gyro in rad/s, (N, 3) accel in m/s^2, (N,)
        dts in s, host arrays; call before `process_frame`. Integrated into
        the frame's and the keyframe's preintegrations as one batch of two,
        each starting from the current bias estimate when new; on the card
        from a CUDA graph per sample count (`device.GraphedCall`: ~2,100
        small operations for 13 samples, enqueued once). Nothing is read
        back; ignored without `cfg.use_imu`."""
        if not self.cfg.use_imu:
            return
        bg, ba = self.imu_bias
        if self._pre_frame is None:
            self._pre_frame = imu_mod.empty_preintegrated(bg, ba)
        if self._pre_kf is None:
            self._pre_kf = imu_mod.empty_preintegrated(bg, ba)
        dts = np.asarray(dts, np.float32)
        if len(dts) == 0:
            return
        with self.timer.span("imu.preintegrate", frame=self.frame_id):
            samples = [to_device(np.asarray(x, np.float32), self.device)
                       for x in (gyro, acc, dts)]
            pres = (self._pre_frame, self._pre_kf)
            out = self._integrate_pair(
                *(getattr(p, f) for p in pres for f in imu_mod.TENSOR_FIELDS), *samples)
        n = len(imu_mod.TENSOR_FIELDS)
        add = float(np.sum(dts, dtype=np.float64))
        self._pre_frame, self._pre_kf = (
            imu_mod.Preintegrated(*out[i * n:(i + 1) * n], dt_host=p.dt_host + add)
            for i, p in enumerate(pres))

    def _flat_integrate_pair(self):
        """`imu.integrate` of the frame's and the keyframe's preintegrations
        (a flat tuple of their fields, then gyro, acc and dts on the card)
        as one batch of two, for `GraphedCall`."""
        ci = self.cfg.imu
        sig = (np.float32(ci.noise_gyro * np.sqrt(ci.freq)),
               np.float32(ci.noise_acc * np.sqrt(ci.freq)),
               np.float32(ci.walk_gyro), np.float32(ci.walk_acc))
        n = len(imu_mod.TENSOR_FIELDS)

        def integrate(*t):
            both = imu_mod.integrate(
                imu_mod.Preintegrated.stack([imu_mod.Preintegrated(*t[:n]),
                                             imu_mod.Preintegrated(*t[n:2 * n])]),
                *t[2 * n:], *sig)
            return tuple(getattr(both, f)[i] for i in range(2) for f in imu_mod.TENSOR_FIELDS)
        return integrate

    # -- per-frame entry ----------------------------------------------------
    def process_frame(self, img, ts: float, depth_map=None) -> dict:
        """img (uint8 or float32; numpy or tensor): a (2, H, W) stereo pair
        for the stereo sensor, an (H, W) or (1, H, W) image for mono and
        RGB-D; `depth_map` (H, W), RGB-D only: the depth of each pixel, 0
        where there is none. Returns {"state", "n_inliers", ...} for the
        frame; on the pipelined path the state and inliers of the last
        consumed frame, with "pipelined": True. With timing on, the frame is
        the root span `frame` of everything it runs."""
        with self.timer.span("frame", frame=self.frame_id), self._counting_pose_evals():
            return self._process_frame(img, ts, depth_map)

    def _process_frame(self, img, ts: float, depth_map) -> dict:
        cfg = self.cfg
        if (depth_map is not None) != (self.sensor == "rgbd"):
            raise ValueError(f"sensor {self.sensor!r}: a depth map goes with RGB-D frames "
                             "and only with them")
        # the bad-IMU reset (Tracking.cc:1858-1863): the mapping set the flag
        if self._bad_imu:
            self._bad_imu = False
            self._drain_pipeline()
            self._reset_active_map()
        # timestamp guards (Tracking.cc:1871-1909): a backwards step resets
        # the map, a gap over 1 s starts a new one
        if self._last_frame_ts is not None and self.state != NOT_INITIALIZED:
            dt_frame = ts - self._last_frame_ts
            if dt_frame < 0.0:
                self._reset_active_map()
            elif dt_frame > 1.0:
                self._new_map()
        self._last_frame_ts = ts

        # slot recycling (reference :792-803): keyframe slots (nearly) used
        # up, or the landmark slots under pressure; a compaction that frees
        # nothing backs off for 64 frames
        if self.state == OK and self.frame_id >= self._compact_backoff and \
                (self._mp_pressure or self._n_kf_host >= self.map.max_kf - 1):
            self._mp_pressure = False
            self._drain_pipeline()
            with self.timer.span("map.compact"):
                compacted = self._compact_map()
            if not compacted:
                self._compact_backoff = self.frame_id + 64

        # the pipelined path: steady-state stereo tracking only;
        # initialisation and a loss drain it and run synchronously
        # (reference :805-810); never with an IMU
        if self.pipeline > 1 and self.state == OK and self.sensor == "stereo" \
                and not cfg.use_imu:
            return self._process_frame_pipelined(img, ts)
        self._drain_pipeline()

        # no SAD refinement on the fisheye path (its rows are not epipolar)
        want_canvas = self.sensor == "stereo" and cfg.stereo.sad_refine \
            and not cfg.stereo.fisheye
        with self.timer.stage("extract"):
            img_dev = self._frame_images(img)
            if self._remap is not None:
                img_dev = self._remap(img_dev)
            thr = float(np.float32(self.threshold.t))
            if self.sensor == "stereo":
                ex = extract_orb_stereo(img_dev, thr, max_kp=cfg.orb.max_kp,
                                        n_levels=cfg.orb.n_levels, return_canvas=want_canvas)
                feats, canvas = ex if want_canvas else (ex, None)
            else:
                feats = extract_orb_mono(img_dev, thr, max_kp=cfg.orb.max_kp,
                                         n_levels=cfg.orb.n_levels)
            self._timer_sync()
        bf, min_z = float(cfg.bf), float(cfg.stereo.min_z)
        with self.timer.stage("stereo_match"):
            if self.sensor == "mono":
                # no depth: every observation is monocular (reference :850-854)
                u_r = torch.full((cfg.orb.max_kp,), -1.0, device=self.device)
                depth = torch.zeros(cfg.orb.max_kp, device=self.device)
            elif self.sensor == "rgbd":
                u_r, depth = self._rgbd_observations(feats, depth_map, img_dev.shape)
            elif self._fisheye_rig is not None:
                u_r, depth = matching.match_fisheye_stereo(
                    feats.xy[0], feats.desc[0], feats.valid[0],
                    feats.xy[1], feats.desc[1], feats.valid[1],
                    self.cam_params, *self._fisheye_rig, bf)
            else:
                u_r, depth = matching.match_rectified_stereo(
                    feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
                    feats.xy[1], feats.level[1], feats.desc[1], feats.valid[1],
                    bf, min_z, n_levels=cfg.orb.n_levels)
                if want_canvas:
                    u_r, depth = matching.refine_stereo_sad(
                        canvas[0], canvas[1], feats.xy[0], feats.level[0],
                        feats.valid[0], u_r, depth, bf=bf, min_z=min_z,
                        n_levels=cfg.orb.n_levels)
            self._timer_sync()
        n_feat = int(feats.n_valid[0])
        self.threshold.update(n_feat)

        # the map-touching section serialises against the mapper thread (the
        # reference's per-frame Map::mMutexMapUpdate, Tracking.cc:1939)
        with self._map_lock:
            if self.state == NOT_INITIALIZED:
                if self.sensor == "mono":
                    out = self._initialize_mono(feats, ts, n_feat)
                else:
                    out = self._initialize_stereo(feats, u_r, depth, ts, n_feat)
            else:
                with self.timer.stage("track"):
                    out = self._track(feats, u_r, depth, ts)
                    self._timer_sync()

            self.frame_id += 1
            self.stats["n_frames"] += 1
            self._pre_frame = None      # consumed; the next feed_imu starts anew
            if self.pose is not None:
                R, t = self.pose
                self.trajectory.append((ts, to_host(R), to_host(t)))
        return out

    def _frame_images(self, img) -> torch.Tensor:
        """The frame on the card: the (2, H, W) stereo pair, or the (H, W)
        image of a mono or RGB-D frame (given as (H, W) or (1, H, W))."""
        x = torch.as_tensor(img, device=self.device)
        if self.sensor == "stereo":
            if x.dim() != 3 or x.shape[0] != 2:
                raise ValueError(f"sensor 'stereo': expected a (2, H, W) pair, got "
                                 f"{tuple(x.shape)}")
            return x
        if x.dim() == 3 and x.shape[0] == 1:
            x = x[0]
        if x.dim() != 2:
            raise ValueError(f"sensor {self.sensor!r}: expected an (H, W) or (1, H, W) "
                             f"image, got {tuple(x.shape)}")
        return x

    def _rgbd_observations(self, feats: Features, depth_map, hw):
        """RGB-D's stereo-equivalent observations (the reference's
        `System._process_rgbd`, system.py:115-141; ORB-SLAM3's Frame RGB-D
        ctor): the depth map (uploaded once per frame, from pinned memory)
        read at each keypoint's truncated pixel, clipped to the image,
        non-positive depths 0, and the virtual right coordinate
        u - bf / max(z, 1e-3) where z > 0, else -1. All on the card, no
        host read."""
        H, W = hw
        if tuple(depth_map.shape) != (H, W):
            raise ValueError(f"depth map {tuple(depth_map.shape)} for an image of {(H, W)}")
        if isinstance(depth_map, torch.Tensor):
            dm = depth_map.to(self.device, torch.float32)
        else:
            dm = to_device(np.asarray(depth_map, np.float32), self.device)
        xy = feats.xy[0]
        xs = torch.clamp(xy[:, 0].to(torch.int64), 0, W - 1)
        ys = torch.clamp(xy[:, 1].to(torch.int64), 0, H - 1)
        z = dm[ys, xs]
        z = torch.where(z > 0, z, torch.zeros_like(z))
        # bf as a tensor: a Python number over a tensor is computed as the
        # number times the reciprocal, which rounds otherwise than numpy's
        # division
        disparity = torch.full_like(z, float(self.cfg.bf)) / torch.clamp(z, min=1e-3)
        u_r = torch.where(z > 0, xy[:, 0] - disparity, torch.full_like(z, -1.0))
        return u_r, z

    def _timer_sync(self):
        """With timing on, a stage ends when the card has finished it."""
        if self.timer.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- initialisation -------------------------------------------------------
    def _initialize_stereo(self, feats: Features, u_r, depth, ts, n_feat) -> dict:
        cfg = self.cfg
        # init gate scaled to the regulated feature budget (the reference's
        # 500 assumes ~1000 features)
        gate = min(cfg.tracker.min_init_features,
                   max(50, round(0.5 * cfg.orb.target_features)))
        if n_feat < gate:
            return {"state": self.state, "n_inliers": 0}
        if self._n_kf_host > 0:
            # a loaded atlas: its current map is archived and tracking
            # starts a map of its own (`load_atlas`)
            self._spawn_new_map()
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
        self._post_init(kf_id, n_mp, ts, feats)
        return {"state": OK, "n_inliers": n_mp, "init": True}

    def _post_init(self, kf_id: int, n_mp: int, ts: float, feats: Features):
        """Tracking starts on the initial map whose last keyframe is kf_id
        (reference :1380-1394): OK, no velocity, kf_id the reference
        keyframe and the only one added to the BoW database; with an IMU its
        stamp starts the keyframe chain."""
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
        self._note_kf_imu(ts)

    def _initialize_mono(self, feats: Features, ts, n_feat) -> dict:
        """MonocularInitialization (Tracking.cc:2505; reference
        :1295-1378). The first frame with at least 100 features anchors the
        attempt; each later frame is matched to it inside 100-pixel windows
        around where its features were last matched
        (`matching.match_for_initialization`). Fewer than 100 matches
        restart the attempt from this frame; otherwise the two views are
        reconstructed (`mapping/twoview.py`) and, when that succeeds, the
        initial map of two keyframes (`_mono_init_map`) is refined by 20
        iterations of BA over both with the first fixed (Global BA in
        CreateInitialMapMonocular). Reads back the match count, the
        reconstruction's verdict, and after a success the map's counts."""
        cfg = self.cfg
        if n_feat < 100:
            self._init_frame = None
            return {"state": self.state, "n_inliers": 0}
        if self._n_kf_host > 0:
            # a loaded atlas: its current map is archived and tracking
            # starts a map of its own (`load_atlas`)
            self._spawn_new_map()
        f = (feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0], feats.angle[0])
        cur = (self._rel_ts(ts),) + f
        if self._init_frame is None:
            self._init_frame = cur
            self._init_prev_xy = f[0]
            return {"state": self.state, "n_inliers": 0}
        ts0, xy0, lvl0, desc0, fv0, ang0 = self._init_frame
        idx, ok = matching.match_for_initialization(
            self._init_prev_xy, desc0, fv0, ang0, f[0], f[2], f[3], f[4],
            window=100.0, th=50.0, ratio=0.9)
        if int(torch.sum(ok.to(torch.int32))) < 100:
            # too few matches: the attempt restarts from this frame
            self._init_frame = cur
            self._init_prev_xy = f[0]
            return {"state": self.state, "n_inliers": 0}
        F = xy0.shape[0]
        uv2 = f[0][torch.clamp(idx, 0, F - 1).long()]
        self._init_prev_xy = torch.where(ok[:, None], uv2, self._init_prev_xy)
        out = reconstruct_two_views(xy0, uv2, ok, self.cam_params)
        if not bool(out["success"]):
            return {"state": self.state, "n_inliers": 0}
        self.map, kf1, R, t = _mono_init_map(
            self.map, ts0, cur[0], self._init_frame[1:], f, idx, out["tri_ok"] & ok,
            out["R"], out["t"], out["p3d"], n_levels=cfg.orb.n_levels)
        self.pose = (R, t)
        self._post_init(kf1, int(self.map.n_mp), ts, feats)
        ids = np.full(cfg.ba.window_size + cfg.ba.n_fixed, -1, np.int32)
        ids[:2] = kf1 - 1, kf1
        fixed = np.zeros(len(ids), bool)
        fixed[0] = True
        self.map = _local_ba(self.map, to_device(ids, self.device),
                             to_device(fixed, self.device), self.cam_params, float(cfg.bf),
                             cam_model=cfg.camera.model_id,
                             n_ba_points=cfg.ba.max_points, n_iters=20)
        self.pose = (self.map.kf_R[kf1].clone(), self.map.kf_t[kf1].clone())
        self._init_frame = None
        self._init_prev_xy = None
        return {"state": OK, "n_inliers": int(self.map.n_mp), "init": True}

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

    def _imu_live(self) -> bool:
        """The IMU predicts this frame: initialised, with samples fed."""
        return bool(self.cfg.use_imu and self.imu_ready and self._pre_frame is not None
                    and self._pre_frame.dt_host > 0)

    def _predict_pose(self, R_last, t_last):
        """The frame's predicted pose and velocity (reference :1397-1410):
        the IMU's dead reckoning from the last pose and the frame's velocity
        when it is live, else the constant-velocity model."""
        if self._imu_live():
            bg, ba = self.imu_bias
            R_bc, t_bc = self._tbc
            Rwb, p_b = imu_mod.body_from_cam(R_last, t_last, R_bc, t_bc)
            R2, v2, p2 = imu_mod.predict_state(Rwb, self.frame_state_v, p_b,
                                               self._pre_frame, bg, ba)
            Rcw, tcw = imu_mod.cam_from_body(R2, p2, R_bc, t_bc)
            return Rcw, tcw, v2
        Rv, tv = (self._dev(x) for x in self.vel)
        R0, t0 = lie.se3_compose(Rv, tv, R_last, t_last)
        return R0, t0, self.frame_state_v

    @contextlib.contextmanager
    def _search_span(self):
        """The `track.search` span, counting the pose solve's evaluations
        made inside it by the kernel and by the torch ops."""
        before = _pose_evals()
        with self.timer.span("track.search") as span:
            yield
            span.set(**{k: now - then
                        for k, now, then in zip(POSE_EVAL_KEYS, _pose_evals(), before)})

    @contextlib.contextmanager
    def _counting_pose_evals(self):
        """Adds the pose solve's evaluations made inside (every solve of
        tracking, the fallback, relocalisation and the pipelined frames)
        to the stats."""
        before = _pose_evals()
        yield
        for k, now, then in zip(POSE_EVAL_KEYS, _pose_evals(), before):
            self.stats[k] += now - then

    def _track(self, feats: Features, u_r, depth, ts) -> dict:
        cfg = self.cfg
        R_last, t_last = (self._dev(x) for x in self.pose)
        R0, t0, v_pred = self._predict_pose(R_last, t_last)
        f0 = (feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0])

        # previous frame's bindings drive the stage-1 restriction and the
        # local map (None right after init: both stages search the map)
        local = bool(cfg.tracker.local_map_tracking)
        prev = self._prev_feat_mp if local else None
        with self._search_span():
            (R, t, mp_feat, _, n_inl, visible, obs, _, feat_mp_out) = _two_stage_core(
                self.map, R0, t0, *f0, u_r, depth, self.cam_params,
                prev_mp=prev, prev_angle=self._prev_feat_angle if prev is not None else None,
                feat_angle=feats.angle[0] if prev is not None else None,
                local_only=local, **self._track_args())
        n_inliers = int(n_inl)
        # MapPoint::IncreaseVisible/IncreaseFound, in place
        self.map.mp_visible += visible
        self.map.mp_found += (mp_feat >= 0).to(torch.float32)

        min_inl = cfg.tracker.min_inliers
        if self._imu_live() and self.anchor_state is not None and n_inliers >= min_inl:
            # the visual-inertial refinement (reference :1438-1463): against
            # the anchor, or chained through the previous frame's marginal
            # prior (ConstraintPoseImu, reset at every keyframe)
            bg, ba = self.imu_bias
            st, n2, H_marg = self._inertial_refine(
                InertialFrameState(R=R, t=t, v=v_pred, bg=bg, ba=ba), obs)
            R, t = st.R, st.t
            self.frame_state_v = st.v
            self.imu_bias = (st.bg, st.ba)
            self._inertial_prior = (st, H_marg)
            n_inliers = max(n_inliers, int(n2))
        else:
            # finite-difference velocity (kept with each keyframe, kf_v)
            _, p_w = lie.se3_inverse(R, t)
            _, p_l = lie.se3_inverse(R_last, t_last)
            dt_f = max(ts - (self.trajectory[-1][0] if self.trajectory else ts - 0.05), 1e-3)
            self.frame_state_v = (p_w - p_l) / dt_f

        if n_inliers < min_inl and self.last_kf_id >= 0:
            # TrackReferenceKeyFrame fallback (Tracking.cc:2778): re-seed from
            # the reference keyframe's landmarks (kernel 2 on the card), then
            # re-run the two-stage track from the recovered pose
            self.stats["ref_kf_fallbacks"] += 1
            with self.timer.span("track.ref_kf_fallback"):
                R_ref, t_ref, n_ref = track_reference_kf(
                    self.map, self.last_kf_id, R_last, t_last, *f0,
                    feats.angle[0], u_r, depth, self.cam_params,
                    cam_model=cfg.camera.model_id, bf=float(cfg.bf),
                    n_levels=cfg.orb.n_levels)
            if int(n_ref) >= min_inl:
                with self._search_span():
                    (R, t, mp_feat, _, n_inl, visible, _, _, feat_mp_out) = \
                        _two_stage_core(self.map, R_ref, t_ref, *f0, u_r, depth,
                                        self.cam_params, **self._track_args())
                n_inliers = int(n_inl)
        if n_inliers < min_inl:
            with self.timer.span("track.reloc"):
                return self._handle_loss(feats, ts, u_r, depth, pred_pose=(R0, t0))

        self.state = OK
        self.lost_since = None
        Ri, ti = lie.se3_inverse(R_last, t_last)
        self.vel = lie.se3_compose(R, t, Ri, ti)
        self.pose = (R, t)
        self.n_inliers_last = n_inliers
        self._prev_feat_mp = feat_mp_out
        self._prev_feat_angle = feats.angle[0]
        if cfg.use_imu and self.imu_ready:
            # the next frame's anchor (reference :1514-1519)
            bg, ba = self.imu_bias
            self.anchor_state = InertialFrameState(R=R, t=t, v=self.frame_state_v, bg=bg, ba=ba)
            self._pre_frame = None

        made_kf = False
        if self._need_new_keyframe(n_inliers, feats, mp_feat, depth, ts):
            self._create_keyframe(feats, u_r, depth, mp_feat, ts, n_inliers)
            made_kf = True
        return {"state": OK, "n_inliers": n_inliers, "kf": made_kf}

    def _inertial_refine(self, cur: InertialFrameState, obs: PoseObs):
        """The frame's visual-inertial solve from the tracked state `cur`:
        against the anchor, or with the previous frame's marginal prior
        (`pose_inertial_optimization(_last_frame)`). On the card each runs
        from a CUDA graph (`device.GraphedCall`: some 40,000 small
        operations a solve, enqueued once). Returns (state, n_inliers,
        H_marg)."""
        prior = self._inertial_prior
        other = prior[0] if prior is not None else self.anchor_state
        pre = self._pre_frame
        with self.timer.span("track.inertial_solve"):
            flat = (*cur, *other, *((prior[1],) if prior is not None else ()),
                    *(getattr(pre, f) for f in imu_mod.TENSOR_FIELDS), *obs, self.cam_params,
                    *self._tbc)
            out = (self._solve_prior if prior is not None else self._solve_anchor)(*flat)
        return InertialFrameState(*out[:5]), out[6], out[7]

    def _flat_inertial_solve(self, with_prior: bool):
        """The frame's inertial solver on a flat tuple of tensors (the
        layout of `_inertial_refine`), for `GraphedCall`."""
        cfg = self.cfg

        def solve(*t):
            cur, other = InertialFrameState(*t[0:5]), InertialFrameState(*t[5:10])
            k = 11 if with_prior else 10
            n = len(imu_mod.TENSOR_FIELDS)
            pre = imu_mod.Preintegrated(*t[k:k + n])
            obs = PoseObs(*t[k + n:k + n + 6])
            cam, R_bc, t_bc = t[k + n + 6:k + n + 9]
            kw = dict(cam_model=cfg.camera.model_id, bf=float(cfg.bf), R_bc=R_bc, t_bc=t_bc)
            if with_prior:
                st, mask, n2, H = pose_inertial_optimization_last_frame(
                    cur, other, t[10], pre, obs, cam, **kw)
            else:
                st, mask, n2, H = pose_inertial_optimization(cur, other, pre, obs, cam, **kw)
            return (*st, mask, n2, H)
        return solve

    def _handle_loss(self, feats: Features, ts: float, u_r=None, depth=None,
                     pred_pose=None) -> dict:
        """Count the failure, enter RECENTLY_LOST and try BoW relocalisation
        (reference :1529-1582, Tracking.cc:2034-2076): the keyframe
        database's candidates (`detect_reloc_candidates`), culled ones
        skipped, each tried in turn (`relocalize_against_kf`); the first
        with >= 50 inliers sets the pose, resets the velocity and counts
        `n_reloc` (the inertial prior predates the jump and is dropped).
        Otherwise the next frames keep tracking from the last pose; with a
        live IMU (reference :1583-1599, Tracking.cc:2042) the IMU-predicted
        pose `pred_pose` becomes the frame's, and with
        `cfg.tracker.insert_kfs_when_lost` a keyframe without landmarks is
        inserted every 0.25 s, so the preintegration chain bridges the gap.
        Lost for more than 5 s, the map is given up (reference
        :1600-1605, `_new_map`): a map of more than 10 keyframes is archived
        in the Atlas and a new one started; a smaller one is reset, also
        where the reference only resets the tracking state and keeps the
        stale map for the next initialisation (ORB-SLAM3 resets the active
        map there)."""
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
                    self._inertial_prior = None
                    self.state = OK
                    self.lost_since = None
                    self.stats["n_reloc"] += 1
                    return {"state": OK, "n_inliers": n_rel, "reloc": True}
        if cfg.use_imu and self.imu_ready and self.state == RECENTLY_LOST \
                and pred_pose is not None:
            self.pose = pred_pose
            if (cfg.tracker.insert_kfs_when_lost and u_r is not None and self._kf_times
                    and ts - self._kf_times[-1] >= 0.25
                    and self._n_kf_host < self.map.max_kf - 1):
                mp_none = torch.full((self.map.max_mp,), -1, dtype=torch.int32,
                                     device=self.device)
                self._create_keyframe(feats, u_r, depth, mp_none, ts, 1)
        if self.lost_since is not None and ts - self.lost_since > 5.0:
            self._new_map()
        return {"state": self.state, "n_inliers": 0}

    def _new_map(self):
        """The map is given up (a loss timeout or a gap in the stamps): one of
        more than 10 keyframes is archived (`_spawn_new_map`), a smaller one
        reset (ResetActiveMap)."""
        if self._n_kf_host > 10:
            self._spawn_new_map()
        else:
            self._reset_active_map()

    def _spawn_new_map(self):
        """CreateMapInAtlas (Tracking.cc:2720, reference :1637-1658): the
        current map stays in the Atlas and its live BoW database goes to the
        map merger, frozen, for a later merge; a new empty map becomes
        current, counted in `n_new_maps`."""
        with self._map_lock:
            self._abort_gba_and_join()
            self._new_map_epoch()
            if self.map_merger is not None and self.place_rec is not None:
                self.map_merger.archive(self.atlas.current, self.place_rec,
                                        gaps=dict(self._gap_by_dst))
            self.atlas.create_new_map()
            self.stats["n_new_maps"] += 1
            self._start_over()

    def _reset_active_map(self):
        """ResetActiveMap: the current map emptied, NOT_INITIALIZED."""
        with self._map_lock:
            self._abort_gba_and_join()
            self._new_map_epoch()
            self.stats["n_resets"] += 1
            mc = self.cfg.map
            self.map = ms.empty_map(mc.max_kf, mc.max_mp, self.cfg.orb.max_kp,
                                    device=self.device)
            self._start_over()

    def _start_over(self):
        """A fresh keyframe database and loop closer for the (empty) current
        map, and NOT_INITIALIZED. The caller has aborted a running GBA (its
        snapshot is of the old map) and started a new map epoch: the chunks
        in flight, the buffered frames, the unread probes and the keyframes
        still queued for the mapper belong to the old map and are dropped."""
        if self.place_rec is not None:
            self.place_rec = make_place_recognition(self.place_rec.voc, self.cfg.map.max_kf,
                                                   prefer_native=False)
            if self.loop_closer is not None:
                n_loops = self.loop_closer.n_loops
                self.loop_closer = LoopCloser(self.cfg, self.place_rec,
                                              fix_scale=self.sensor != "mono",
                                              timer=self.timer)
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
        self._init_frame = None
        self._init_prev_xy = None
        # the inertial chain starts over (reference :1620-1632); the bias
        # estimate, the velocity and the open preintegrations are kept
        self.imu_ready = False
        if self.loop_closer is not None:
            self.loop_closer.inertial = False
        if self.map_merger is not None:
            self.map_merger.inertial = False
        self._imu_init_ts = None
        self._viba_stage = 0
        self._next_scale_ref_ts = None
        self._kf_preints, self._kf_times = [], []
        self._gap_by_dst, self._prev_note_kf_id = {}, -1
        self._inertial_prior = None
        self._bad_imu = False
        self._kf_centers = []

    def load_atlas(self, atlas: Atlas):
        """Continue from a loaded Atlas (`System.load_atlas`). The pipeline
        is flushed and the threads' work waited for; then the tracker starts
        over on the loaded maps: NOT_INITIALIZED, the live BoW database
        rebuilt from the loaded current map, and the map merger's archives
        rebuilt, one frozen database per other loaded map. The next
        initialisation archives the loaded current map too and starts a map
        of its own, as ORB-SLAM3's System creates a new map after loading an
        atlas; a revisit then merges the loaded maps in.

        Named exception: the reference's `System.load_atlas` swaps the Atlas
        and nothing else (its system.py:207-209), so its live database, its
        merger's archives and its tracking state still describe the maps it
        had, and its next initialisation inserts a keyframe at the identity
        pose into the loaded map's world (ROADMAP queue 3)."""
        if atlas.device != self.device:
            raise ValueError(f"the atlas is on {atlas.device}, the tracker on {self.device}")
        self.finish()
        with self._map_lock:
            self._abort_gba_and_join()
            self._new_map_epoch()
            self.atlas = atlas
            self._start_over()
            self._ensure_place_rec(None)
            if self.place_rec is not None:
                self._rebuild_place_rec()
            if self.map_merger is not None:
                self.map_merger = MapMerger(self.cfg)
                for i, m in enumerate(atlas.maps):
                    if i != atlas.current and bool(m.kf_valid.any()):
                        self.map_merger.archive(i, self._bow_database(m))
            self._n_kf_host = int(self.map.n_kf)

    def _new_map_epoch(self):
        """The map's ids change meaning (a reset or a compaction): drop what
        carries the old ones. The mapper skips queued ids of an older epoch."""
        self._map_epoch += 1
        self._pending = []
        self.stats["frames_skipped"] += len(self._img_buf)
        self._img_buf = []
        self._probe_unfetched = []
        self._chain = None
        self._kf_wall = {}

    # -- keyframe policy (NeedNewKeyFrame, Tracking.cc:3125) ----------------
    def _need_new_keyframe(self, n_inliers, feats: Features, mp_feat, depth, ts) -> bool:
        cfg = self.cfg
        if self._n_kf_host >= self.map.max_kf - 1:
            return False
        # an inertial map needs dense keyframes: every 0.25 s before the IMU
        # is initialised, 0.5 s after (reference :1685-1690)
        if cfg.use_imu and self._kf_times:
            gap = ts - self._kf_times[-1]
            if (not self.imu_ready and gap >= 0.25) or (self.imu_ready and gap >= 0.5):
                return True
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
        """NeedNewKeyFrame from pre-reduced scalars (reference
        :1209-1235). With the mapper thread, c1b needs it idle, and a busy
        mapper takes a stereo or RGB-D keyframe only while fewer than 3 wait
        (Tracking.cc: KeyframesInQueue() < 3). Monocular: no close-point
        condition c1c, the inlier ratio 0.9 and no short-queue acceptance."""
        cfg = self.cfg
        if self._n_kf_host >= self.map.max_kf - 1:
            return False
        q = self._map_queue
        mapper_idle = q is None or q.unfinished_tasks == 0
        frames_since = frame_id - self.last_kf_frame
        c1a = frames_since >= cfg.tracker.max_frames_between_kf
        c1b = frames_since >= max(cfg.tracker.min_frames_between_kf, 1) and mapper_idle
        depth = self.sensor != "mono"
        c1c = depth and (n_close_tracked < cfg.tracker.close_tracked_th
                         and n_close_untracked > cfg.tracker.close_untracked_th)
        ratio = cfg.tracker.kf_ref_ratio if depth else 0.9
        c2 = n_inliers < ratio * max(self.ref_kf_matches, 1) and n_inliers > 15
        want = bool(((c1a or c1b or c1c) and c2) or (c1c and c1b))
        if want and not mapper_idle and depth:
            want = q.unfinished_tasks < 3
        return want

    def _create_keyframe(self, feats: Features, u_r, depth, mp_feat, ts,
                         n_inliers):
        cfg = self.cfg
        R, t = (self._dev(x) for x in self.pose)
        bg, ba = self.imu_bias
        # monocular keyframes spawn no landmark (their depths are 0 anyway):
        # new ones come from local mapping's triangulation
        close_depth = -1.0 if self.sensor == "mono" else \
            float(cfg.stereo.depth_factor * cfg.stereo.baseline)
        with self.timer.span("keyframe.insert"):
            self.map, kf_id = _insert_kf_and_spawn(
                self.map, R, t, self._rel_ts(ts), feats.xy[0], feats.level[0],
                feats.desc[0], feats.valid[0], u_r, depth, mp_feat,
                self.cam_params, close_depth,
                cam_model=cfg.camera.model_id, n_levels=cfg.orb.n_levels,
                v=self.frame_state_v, bg=bg, ba=ba, angle=feats.angle[0],
                img_w=cfg.camera.width, img_h=cfg.camera.height,
                th_far=cfg.tracker.th_far_points)
        self.last_kf_frame = self.frame_id
        self.last_kf_id = int(kf_id)
        self.ref_kf_matches = max(n_inliers, 1)
        self.stats["n_kf"] += 1
        if kf_id >= 0:
            self._kf_wall[kf_id] = time.perf_counter()
            self._kf_frame[kf_id] = self.frame_id
            self._n_kf_host = kf_id + 1
            if kf_id % 8 == 0:
                self._probe_mp_pressure()
        self._note_kf_imu(ts)
        if kf_id >= 0:
            self._queue_mapping(kf_id, lagged_loops=False)

    def _create_keyframe_from_record(self, rec: "_Chunk", c: int, R, t, n_inl: int):
        """A keyframe from frame `c` of a consumed chunk (reference
        :1237-1264), at the consumed pose, under the host's keyframe id (no
        read of the map's count)."""
        cfg = self.cfg
        _, xy, level, angle, desc, valid, u_r, depth, mp_feat = rec.outs[c]
        kid = self._n_kf_host
        with self.timer.span("keyframe.insert", frame=rec.fids[c]):
            self.map, _ = _insert_kf_and_spawn(
                self.map, self._dev(R), self._dev(t), self._rel_ts(rec.ts[c]), xy, level,
                desc, valid, u_r, depth, mp_feat, self.cam_params,
                float(cfg.stereo.depth_factor * cfg.stereo.baseline),
                cam_model=cfg.camera.model_id, n_levels=cfg.orb.n_levels, angle=angle,
                img_w=cfg.camera.width, img_h=cfg.camera.height,
                th_far=cfg.tracker.th_far_points, kf_id=kid)
        self._n_kf_host = kid + 1
        self.last_kf_frame = rec.fids[c]
        self.last_kf_id = kid
        self.ref_kf_matches = max(n_inl, 1)
        self.stats["n_kf"] += 1
        self._kf_wall[kid] = time.perf_counter()
        self._kf_frame[kid] = rec.fids[c]
        if kid % 8 == 0:
            self._probe_mp_pressure()
        self._queue_mapping(kid, lagged_loops=True)

    def _queue_mapping(self, kid: int, lagged_loops: bool):
        """The keyframe's back end: on the mapper thread when there is one,
        else inline. A new keyframe aborts a global BA that runs inline on
        the mapper thread (it would hold the queue); a dedicated GBA thread
        (async_gba) keeps running: only a newer loop, a compaction or a
        reset aborts it (reference :1735-1742; its pipelined keyframe
        :1259-1261 aborts that thread as well, which the port does not)."""
        q = self._map_queue
        if q is None:
            self._mapping_pipeline(kid, lagged_loops=lagged_loops)
            return
        lc = self.loop_closer
        if lc is not None and not lc.async_gba:
            lc.abort_gba = True
        q.put((self._map_epoch, kid))

    def _probe_mp_pressure(self):
        """Landmark-slot pressure without waiting for the card (reference
        :1198-1207): read the landmark count copied 8 keyframes ago, then
        start a copy of the current one. The 90% threshold absorbs the lag."""
        prev = self._mp_pressure_probe
        if prev is not None:
            n_mp, done = prev
            if done is not None:
                done.synchronize()
            self._mp_pressure = int(n_mp) >= 0.9 * self.map.max_mp
        n_mp = self.map.n_mp.to("cpu", non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._mp_pressure_probe = (n_mp, done)

    # -- slot recycling (reference :661-712) ----------------------------------
    def _compact_map(self) -> bool:
        """Compact the map's culled keyframe and landmark slots away
        (`map_state.compact_map`) and remap every host-side id: the last
        keyframe, the loop closer's last loop keyframe and loop edges (its
        consistency state restarts), the previous frame's landmark bindings,
        and the BoW database, rebuilt from the map. The mapper's queue is
        drained first and a running GBA aborted (their ids are the old
        map's); the pipelined chain restarts. Returns False when nothing was
        freed.

        The previous frame's bindings are remapped through `mp_new`, ids of
        dropped landmarks becoming -1. The reference leaves them as they were
        (its `_compact_map` at tracker.py:661-699 does not touch
        `_prev_feat_mp`), so after its compaction the next frame's stage-1
        search and local-map mask read other landmarks' slots; the port does
        not carry that fault over (ROADMAP queue 3)."""
        self.wait_mapping_idle()
        self._abort_gba_and_join()
        with self._map_lock:
            m = self.map
            n_kf_b, n_mp_b = int(m.n_kf), int(m.n_mp)
            m2, kf_new, mp_new = ms.compact_map(m)
            n_kf_a, n_mp_a = int(m2.n_kf), int(m2.n_mp)
            if n_kf_a >= n_kf_b and n_mp_a >= n_mp_b:
                return False
            kf_new_np = kf_new.cpu().numpy()
            self.map = m2
            self._new_map_epoch()
            self._n_kf_host = n_kf_a
            if 0 <= self.last_kf_id < len(kf_new_np):
                self.last_kf_id = int(kf_new_np[self.last_kf_id])
            self._remap_prev_feat_mp(mp_new)
            lc = self.loop_closer
            if lc is not None:
                if 0 <= lc.last_loop_kf < len(kf_new_np):
                    lc.last_loop_kf = int(kf_new_np[lc.last_loop_kf])
                lc.consistent_candidate = -1
                lc.consistency_count = 0
                lc.remap_keyframes(kf_new_np)
            if self.place_rec is not None:
                self._rebuild_place_rec()
            self.stats["n_compactions"] += 1
            return True

    def _remap_prev_feat_mp(self, mp_new: torch.Tensor):
        prev = self._prev_feat_mp
        if prev is not None:
            P = mp_new.shape[0]
            self._prev_feat_mp = torch.where(
                prev >= 0, mp_new[torch.clamp(prev, 0, P - 1).long()], -1).to(torch.int32)

    def _bow_database(self, m: ms.MapState):
        """A BoW database of the valid keyframes of map `m`."""
        db = make_place_recognition(self.place_rec.voc, self.cfg.map.max_kf,
                                    prefer_native=False)
        for k in np.flatnonzero(m.kf_valid.cpu().numpy()):
            db.add(int(k), m.kf_desc[int(k)], m.kf_feat_valid[int(k)])
        return db

    def _rebuild_place_rec(self):
        """The live BoW database rebuilt from the current map (after a
        compaction re-indexed the slots, a merge added keyframes, or a
        load; reference :701-710)."""
        self.place_rec = self._bow_database(self.map)
        if self.loop_closer is not None:
            self.loop_closer.pr = self.place_rec

    # -- the per-keyframe back end ------------------------------------------
    def _ensure_place_rec(self, desc_bits):
        """Load the vocabulary (cfg.map.vocabulary_path, else the shipped
        one) and make the keyframe database; without a vocabulary file,
        train a small one from the first frame's descriptors, as the
        reference does (tracker.py:714-737); with no descriptors given
        (`load_atlas`) there is then no database yet."""
        if self.place_rec is not None:
            return
        path = self.cfg.map.vocabulary_path or DEFAULT_VOCAB_PATH
        if os.path.exists(path):
            voc = load_vocabulary(path, device=self.device)
        elif desc_bits is None:
            return
        else:
            d = desc_bits.cpu().numpy()
            extra = np.random.default_rng(0).integers(0, 2, size=(2048, 256)).astype(np.int8)
            voc = train_vocabulary(np.concatenate([d, extra]), k=8, depth=3).to(self.device)
        self.place_rec = make_place_recognition(voc, self.cfg.map.max_kf, prefer_native=False)
        if self.enable_loop_closing:
            # stereo and RGB-D: depth fixes the scale; monocular loops
            # solve a free-scale Sim(3) (reference :655-657)
            self.loop_closer = LoopCloser(self.cfg, self.place_rec,
                                          fix_scale=self.sensor != "mono", timer=self.timer)
            if self.map_merger is None:
                self.map_merger = MapMerger(self.cfg)

    def _mapping_pipeline(self, kid: int, lagged_loops: bool = False):
        """Per-keyframe mapping (reference :1859-1927, the fused branch):
        BoW add + cull / triangulate / fuse / keyframe culling + the loop
        probe as one queue of device work, then local BA unless a further
        keyframe already waits for the mapper (LocalMapping.cc:151-158);
        then, when the keyframe passes the probe gates, the probe pack is
        read and consumed (`_consume_probes`), or with `lagged_loops` (the
        pipelined path) only kept, to ride the next chunk's read. The probe
        runs whenever a loop closer exists, as in the reference. With timing
        on, all of it is the span `keyframe.backend`, under the id of the
        frame that made the keyframe (also on the mapper thread)."""
        with self.timer.span("keyframe.backend", frame=self._kf_frame.get(kid)):
            self._mapping_steps(kid, lagged_loops)

    def _mapping_steps(self, kid: int, lagged_loops: bool):
        cfg = self.cfg
        pr = self.place_rec
        voc = pr.voc
        lc = self.loop_closer
        want_probe = lc is not None and lc.probe_gates_ok(kid, self._n_kf_host)
        dev = self.device
        with self.timer.span("mapping.mapper_step"):
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
        q = self._map_queue
        if q is None or q.unfinished_tasks <= 1:
            self._run_local_ba(kid)
        if want_probe:
            if lagged_loops:
                self._probe_unfetched.append((kid, probe))
            else:
                self._consume_probes([(kid, probe.cpu().numpy())])
        mm = self.map_merger
        if mm is not None and mm.archives:
            with self.timer.span("mapping.merge"):
                self._detect_merge(kid)
        if cfg.use_imu and self.imu_ready:
            self._inertial_back_end(kid)

    def _inertial_back_end(self, kid: int):
        """After a keyframe's visual back end, once the IMU is initialised
        (reference :1990-2016): the windowed VI-BA, then the staged full VI
        passes, VIBA1 more than 5 s after the initialisation and VIBA2 more
        than 15 s after, then (monocular) the scale refinement every 10 s
        from 25 s on."""
        self._run_vi_window(kid)
        t_init = (self._kf_times[-1] - self._imu_init_ts
                  if self._imu_init_ts is not None and self._kf_times else 0.0)
        if self._viba_stage < 1 and t_init > 5.0:
            self._run_full_inertial_ba(kid)
            self._viba_stage = 1
        elif self._viba_stage < 2 and t_init > 15.0:
            self._run_full_inertial_ba(kid)
            self._viba_stage = 2
            self._next_scale_ref_ts = self._imu_init_ts + 25.0
        elif (self.sensor == "mono" and self._viba_stage >= 2
              and self._next_scale_ref_ts is not None and self._kf_times
              and self._kf_times[-1] >= self._next_scale_ref_ts):
            self._refine_scale()
            self._next_scale_ref_ts += 10.0

    def _detect_merge(self, kid: int):
        """Merge detection on keyframe `kid` (reference :1961-1990): the map
        merger queries the archived maps and may weld one into the current
        map. After a merge: a running GBA is aborted (its snapshot predates
        the merge), `n_map_merges` counts it, the live BoW database is
        rebuilt from the merged map and the host's keyframe count re-read;
        off the mapper thread the pose becomes the keyframe's.

        The pipelined chain and the chunks in flight are kept as they are:
        the merge leaves the current map's world and its landmark slots as
        they were and appends the archived keyframes after the last one, and
        the welding BA holds `kid` fixed and moves only its 3 predecessors
        and the archived map's keyframes, so the tracker's last keyframe (kid
        or a later one) and the chain's bindings keep their values. Keyframe
        ids queued for the mapper stay valid for the same reason."""
        mm = self.map_merger
        if not mm.on_keyframe(self.atlas, kid, self.cam_params):
            return
        self._abort_gba_and_join()
        self.stats["n_map_merges"] += 1
        self._inertial_prior = None     # the merge moved poses
        self._n_kf_host = int(self.map.n_kf)
        self._rebuild_place_rec()
        if self.cfg.use_imu and self.imu_ready:
            # MergeInertialBA (Optimizer.cc:3985): the archived map's
            # preintegrations rejoin the registry, and a VI-BA welds the two
            # inertial chains over the seam
            self._gap_by_dst.update(mm.last_merge["gaps"])
            self._merge_inertial_ba(mm.last_merge["kf_cur"], mm.last_merge["kf_old"])
        if not self._in_mapper_thread:
            self.pose = (self.map.kf_R[kid].clone(), self.map.kf_t[kid].clone())

    def _consume_probes(self, probe_list) -> list:
        """The loop closer on read probe packs [(kid, 16 floats)] (reference
        :1017-1050): landmark pressure from the pack's n_mp slot (the next
        frame compacts the map when it is set), then the consistency
        machine, verification, correction and the global BA (inline, or
        started on its thread with async_gba). After a loop: `n_loops`,
        `loop_latency_ms` (keyframe creation to corrected map, host clock),
        the pipelined chain restarts, and off the mapper thread the pose is
        the corrected keyframe's. Returns the rigid delta of each correction
        (float64 host arrays), to compose onto poses still in flight."""
        lc = self.loop_closer
        deltas = []
        for kid, pv in probe_list:
            if pv[11] > 0:
                self._mp_pressure = bool(pv[11] >= 0.9 * self.map.max_mp)
            n_before = lc.n_loops
            with self.timer.span("loop.probe", frame=self._kf_frame.get(kid)) as sp:
                self.map = lc.on_probe_result(self.map, kid, pv, self.cam_params)
                sp.set(closed=int(lc.n_loops > n_before))
            if lc.n_loops > n_before:
                self.stats["n_loops"] += 1
                if kid in self._kf_wall:
                    self.stats["loop_latency_ms"] = round(
                        (time.perf_counter() - self._kf_wall[kid]) * 1e3, 1)
                self._chain = None
                # the marginal prior holds a pose from before the correction
                self._inertial_prior = None
                if not self._in_mapper_thread:
                    self.pose = (self.map.kf_R[kid].clone(), self.map.kf_t[kid].clone())
                self._maybe_start_gba(self._kf_frame.get(kid))
                dR, dt = lc.last_delta
                deltas.append((dR.cpu().numpy().astype(np.float64),
                               dt.cpu().numpy().astype(np.float64)))
        return deltas

    def _run_local_ba(self, kf_id: int):
        """Local BA from the third keyframe on (reference :2197-2225), over
        the covisibility window with its oldest members fixed, or with
        `cfg.mapping.covis_ba_window` off over the fixed window
        (`fixed_ba_window`); off the mapper thread the tracker's pose becomes
        the keyframe's optimised one."""
        cfg = self.cfg
        if self._n_kf_host < 3:
            return
        with self.timer.span("mapping.local_ba"):
            if cfg.mapping.covis_ba_window:
                ids, fixed = lm_ops.covis_ba_window(
                    self.map, torch.full((), kf_id, dtype=torch.int32, device=self.device),
                    n_win=cfg.ba.window_size, n_fixed=cfg.ba.n_fixed)
            else:
                ids, fixed = (to_device(a, self.device) for a in fixed_ba_window(
                    self._n_kf_host, cfg.ba.window_size, cfg.ba.n_fixed))
            self.map = _local_ba(self.map, ids, fixed, self.cam_params, float(cfg.bf),
                                 cam_model=cfg.camera.model_id,
                                 n_ba_points=cfg.ba.max_points, n_iters=cfg.ba.n_iters)
        self.stats["n_local_ba"] += 1
        if not self._in_mapper_thread:
            # copies: the map's rows change in place at the next keyframe
            self.pose = (self.map.kf_R[kf_id].clone(), self.map.kf_t[kf_id].clone())

    # -- the inertial back end (reference :2019-2316) ---------------------------
    def _window_pres(self, sel, C: int):
        """The stacked preintegrations of the C - 1 gaps of window `sel`
        (registered gaps between consecutive members, empty ones elsewhere)
        and their validity."""
        pres, valid = [], np.zeros(C - 1, bool)
        for i in range(len(sel) - 1):
            src, pre = self._gap_by_dst.get(sel[i + 1], (None, None))
            if src == sel[i] and pre is not None:
                pres.append(pre)
                valid[i] = True
            else:
                pres.append(imu_mod.empty_preintegrated(device=self.device))
        while len(pres) < C - 1:
            pres.append(imu_mod.empty_preintegrated(device=self.device))
        return imu_mod.Preintegrated.stack(pres), to_device(valid, self.device)

    def _vi_ba(self, sel, C: int, fixed: np.ndarray, n_iters: int):
        """`local_inertial_ba` over the keyframes `sel` (padded to C) with
        the current bias as its start and the keyframes' stored velocities,
        written into the map; the bias estimate becomes the newest
        keyframe's. Returns the result."""
        cfg = self.cfg
        ids = np.full(C, -1, np.int32)
        ids[:len(sel)] = sel[:C]
        pres, pre_valid = self._window_pres(sel, C)
        idsd = to_device(ids, self.device)
        fixedd = to_device(fixed, self.device)
        v_init = self.map.kf_v[torch.clamp(idsd, 0, self.map.max_kf - 1).long()]
        bg, ba = self.imu_bias
        R_bc, t_bc = self._tbc
        res = local_inertial_ba(
            self.map, idsd, fixedd, pres, pre_valid, bg, ba, self.cam_params, float(cfg.bf),
            cam_model=cfg.camera.model_id, n_iters=n_iters, n_levels=cfg.orb.n_levels,
            R_bc=R_bc, t_bc=t_bc, v_init=v_init,
            v_init_valid=torch.linalg.norm(v_init, dim=-1) > 1e-9,
            per_kf_bias=bool(cfg.ba.per_kf_bias))
        self.map = apply_vi_window(self.map, idsd, fixedd, res)
        self.imu_bias = (res.bg, res.ba) if res.bg.dim() == 1 else \
            (res.bg[len(sel) - 1], res.ba[len(sel) - 1])
        return res

    def _run_vi_window(self, kf_id: int, window_cap: Optional[int] = None,
                       n_iters: Optional[int] = None):
        """LocalInertialBA over the longest chain of consecutive keyframes
        ending at kf_id whose gaps all have preintegrations (at most
        `window_size + 1`, at least 3), its oldest keyframe fixed (reference
        :2019-2066). Off the mapper thread the tracker's pose, velocity and
        anchor become the keyframe's."""
        cfg = self.cfg
        C = window_cap if window_cap is not None else cfg.ba.window_size + 1
        sel = self._chain_back(kf_id, C)
        if len(sel) < 3:
            return
        fixed = np.zeros(C, bool)
        fixed[0] = True
        with self.timer.span("mapping.vi_window"):
            res = self._vi_ba(sel, C, fixed,
                              n_iters if n_iters is not None else cfg.ba.n_iters)
        if not self._in_mapper_thread:
            v = res.v[len(sel) - 1]
            R, t = self.map.kf_R[kf_id].clone(), self.map.kf_t[kf_id].clone()
            self.frame_state_v = v
            self.pose = (R, t)
            bg, ba = self.imu_bias
            self.anchor_state = InertialFrameState(R=R, t=t, v=v, bg=bg, ba=ba)

    def _chain_back(self, k: int, cap: int) -> List[int]:
        """The longest run of consecutive keyframe ids ending at k whose gaps
        all have registered preintegrations, oldest first, at most cap."""
        sel = [k]
        while len(sel) < cap:
            src = self._gap_by_dst.get(k, (None, None))[0]
            if src != k - 1 or k - 1 < 0:
                break
            k -= 1
            sel.append(k)
        sel.reverse()
        return sel

    MERGE_VI_HALF = 4   # keyframes on each side of the inertial weld

    def _merge_inertial_ba(self, kf_cur: int, kf_old: int):
        """MergeInertialBA (Optimizer.cc:3985, reference :2085-2135): a VI-BA
        over up to MERGE_VI_HALF keyframes of each map's chain at the seam,
        the current keyframe fixed. Each side keeps its own inertial edges;
        the seam pair has none (the maps' IMU streams are disjoint)."""
        sel = self._chain_back(kf_old, self.MERGE_VI_HALF) + \
            self._chain_back(kf_cur, self.MERGE_VI_HALF)
        if len(sel) < 3:
            return
        C = 2 * self.MERGE_VI_HALF
        fixed = np.zeros(C, bool)
        fixed[:len(sel)] = [k == kf_cur for k in sel[:C]]
        if not fixed.any():
            fixed[0] = True
        self._vi_ba(sel, C, fixed, self.cfg.ba.n_iters)

    FULL_VI_WINDOW = 24   # keyframes of VIBA1 / VIBA2's full chain

    def _run_full_inertial_ba(self, kf_id: int, rounds: int = 2):
        """FullInertialBA (Optimizer.cc:390) as the reference runs it at
        VIBA1 and VIBA2 (reference :2142-2166): `rounds` of a visual BA over
        the last FULL_VI_WINDOW keyframes (oldest fixed) followed by the VI
        pass over the chain ending at kf_id."""
        cfg = self.cfg
        C = min(self.FULL_VI_WINDOW, self.map.max_kf)
        n_kf = self._n_kf_host
        sel = list(range(max(0, n_kf - C), n_kf))
        ids = np.full(C, -1, np.int32)
        ids[:len(sel)] = sel
        fixed = np.zeros(C, bool)
        fixed[0] = True
        idsd, fixedd = to_device(ids, self.device), to_device(fixed, self.device)
        with self.timer.span("mapping.full_vi_ba"):
            for _ in range(rounds):
                if len(sel) >= 2:
                    self.map = _local_ba(self.map, idsd, fixedd, self.cam_params,
                                         float(cfg.bf), cam_model=cfg.camera.model_id,
                                         n_ba_points=min(cfg.ba.max_points, self.map.max_mp),
                                         n_iters=cfg.ba.n_iters)
                self._run_vi_window(kf_id, window_cap=C)
        if not self._in_mapper_thread:
            self.pose = (self.map.kf_R[kf_id].clone(), self.map.kf_t[kf_id].clone())

    def _init_window(self):
        """The keyframes and gaps of the inertial initialisation: the last
        len(_kf_preints) + 1 keyframe ids and the gaps' stacked
        preintegrations, or None when they do not line up."""
        n_kf = self._n_kf_host
        k_ids = list(range(max(0, n_kf - len(self._kf_preints) - 1), n_kf))
        if len(k_ids) < 2 or len(self._kf_preints) < len(k_ids) - 1:
            return None
        return k_ids, imu_mod.Preintegrated.stack(self._kf_preints[-(len(k_ids) - 1):])

    def _solve_init(self, k_ids, pres, opt_scale: bool):
        ids = to_device(np.asarray(k_ids, np.int64), self.device)
        K = len(k_ids)
        R_bc, t_bc = self._tbc
        return inertial_init_optimization(
            self.map.kf_R[ids], self.map.kf_t[ids],
            torch.ones(K, dtype=torch.bool, device=self.device), pres,
            torch.ones(K - 1, dtype=torch.bool, device=self.device), opt_scale=opt_scale,
            R_bc=R_bc, t_bc=t_bc)

    def _refine_scale(self):
        """LocalMapping::ScaleRefinement (reference :2169-2196): the
        initialisation problem with scale over the recent chain; a scale in
        (0.5, 2) rescales and re-levels the whole map."""
        win = self._init_window()
        if win is None or len(win[0]) < 3:
            return
        R_wg, bg, ba, s, _ = self._solve_init(*win, opt_scale=True)
        s_f = float(s)
        if not 0.5 < s_f < 2.0:
            return
        self.map = transform_map(self.map, R_wg.T, torch.zeros(3, device=self.device), s_f)
        self.imu_bias = (bg, ba)
        if not self._in_mapper_thread and self.last_kf_id >= 0:
            k = self.last_kf_id
            self.pose = (self.map.kf_R[k].clone(), self.map.kf_t[k].clone())

    def _note_kf_imu(self, ts: float):
        """A keyframe at stamp ts joins the inertial chain (reference
        :2228-2253): the preintegration since the previous keyframe is kept
        (in order, and as the gap ending at this keyframe), the stamp and
        the camera centre recorded, the bad-IMU check run; the next frame
        solves against the keyframe (no prior), and the keyframe
        preintegration restarts at the current bias. After 6 gaps over at
        least 1 s the IMU is initialised."""
        if not self.cfg.use_imu:
            return
        pre = self._pre_kf
        if pre is not None and pre.dt_host > 0 and self._kf_times:
            self._kf_preints.append(pre)
            if self._prev_note_kf_id >= 0:
                self._gap_by_dst[self.last_kf_id] = (self._prev_note_kf_id, pre)
        self._prev_note_kf_id = self.last_kf_id
        self._kf_times.append(ts)
        if self.pose is not None:
            R = to_host(self.pose[0]).astype(np.float64)
            t = to_host(self.pose[1]).astype(np.float64)
            self._kf_centers.append(-R.T @ t)
            del self._kf_centers[:-3]
            self._check_bad_imu()
        self._inertial_prior = None
        bg, ba = self.imu_bias
        self._pre_kf = imu_mod.empty_preintegrated(bg, ba)
        if (not self.imu_ready and len(self._kf_preints) >= 6
                and self._kf_times[-1] - self._kf_times[0] >= 1.0):
            self._initialize_imu()

    def _check_bad_imu(self):
        """The bad-IMU guard (LocalMapping.cc:140-147, reference
        :2255-2273): between the initialisation and VIBA2, within 10 s of
        the initialisation, the last two keyframe gaps moving less than
        2 cm together leave scale and gravity unobservable; the flag resets
        the map at the next frame."""
        if (not self.cfg.use_imu or not self.imu_ready or self._viba_stage >= 2
                or self._imu_init_ts is None or len(self._kf_centers) < 3
                or not self._kf_times):
            return
        c = self._kf_centers
        dist = np.linalg.norm(c[-1] - c[-2]) + np.linalg.norm(c[-2] - c[-3])
        if self._kf_times[-1] - self._imu_init_ts < 10.0 and dist < 0.02:
            self._bad_imu = True

    def _initialize_imu(self):
        """InitializeIMU (LocalMapping.cc:1196, reference :2275-2316):
        gravity, biases and (monocular, with a scale below 0.1 aborting) the
        scale over the keyframe chain; the map turned into the gravity
        frame (and scaled), the frame's velocity and the bias set, the loop
        closer and the map merger switched to their inertial forms, and the
        pose and anchor re-read from the last keyframe."""
        win = self._init_window()
        if win is None:
            return
        opt_scale = self.sensor == "mono"
        R_wg, bg, ba, s, v = self._solve_init(*win, opt_scale=opt_scale)
        s_f = float(s) if opt_scale else 1.0
        if opt_scale and s_f < 0.1:
            return
        Rgw = R_wg.T
        self.map = transform_map(self.map, Rgw, torch.zeros(3, device=self.device), s_f)
        self.imu_bias = (bg, ba)
        self.frame_state_v = Rgw @ v[-1]
        self.imu_ready = True
        if self.loop_closer is not None:
            self.loop_closer.inertial = True
        if self.map_merger is not None:
            self.map_merger.inertial = True
        self._imu_init_ts = self._kf_times[-1] if self._kf_times else None
        k = self.last_kf_id
        self.pose = (self.map.kf_R[k].clone(), self.map.kf_t[k].clone())
        self.anchor_state = InertialFrameState(R=self.pose[0], t=self.pose[1],
                                               v=self.frame_state_v, bg=bg, ba=ba)

    # -- the pipelined path (reference :876-1281) -----------------------------
    def _process_frame_pipelined(self, img, ts: float) -> dict:
        """Buffer the frame (uploaded from pinned memory, no wait), dispatch
        a chunk when `chunk` frames wait, then consume the chunks whose
        packs have reached the host."""
        if isinstance(img, torch.Tensor) and img.device.type != "cpu":
            img_dev = img.to(self.device)
        else:
            img_dev = to_device(np.asarray(img), self.device)
        if img_dev.dim() != 3 or img_dev.shape[0] != 2:
            raise ValueError(f"expected a (2, H, W) stereo pair, got {tuple(img_dev.shape)}")
        self._img_buf.append((img_dev, ts, self.frame_id))
        self.frame_id += 1
        self.stats["n_frames"] += 1
        if len(self._img_buf) >= self.chunk:
            self._dispatch_chunk()
        self._finalize_impl(drain=False)
        return {"state": self.state, "n_inliers": self.n_inliers_last, "pipelined": True}

    def _chunk_args(self) -> dict:
        cfg = self.cfg
        args = self._track_args()
        args.update(min_z=float(cfg.stereo.min_z), max_kp=cfg.orb.max_kp,
                    close_depth=float(cfg.stereo.depth_factor * cfg.stereo.baseline),
                    fisheye=bool(cfg.stereo.fisheye), sad_refine=bool(cfg.stereo.sad_refine))
        return args

    def _dispatch_chunk(self):
        """Run the buffered frames as one chunk (reference :912-997) and
        start the copy of their packs, with every waiting loop probe up to
        PROBE_SLOTS, into a pinned host buffer of the chunk's own; an event
        recorded after the copy tells when it has landed. Reads nothing
        back: the chain and the landmark statistics stay on the card."""
        buf, self._img_buf = self._img_buf, []
        if not buf:
            return
        cfg = self.cfg
        dev = self.device
        with self._map_lock, self.timer.stage("pipeline_dispatch"):
            if self._chain is None:
                F = cfg.orb.max_kp
                self._chain = (*(self._dev(x) for x in self.pose),
                               *(self._dev(x) for x in self.vel),
                               torch.full((F,), -1, dtype=torch.int32, device=dev),
                               torch.zeros(F, device=dev))
            imgs = [b[0] for b in buf]
            if self._remap is not None:
                imgs = list(self._remap(torch.stack(imgs)).unbind(0))
            self._chain, vis, found, outs = _frame_step_chunk(
                self.map, self._chain, imgs, float(np.float32(self.threshold.t)),
                self.cam_params, self._fisheye_rig,
                local_only=bool(cfg.tracker.local_map_tracking), ref_kf=self.last_kf_id,
                **self._chunk_args())
            self.map.mp_visible, self.map.mp_found = vis, found
            probes = self._probe_unfetched[:self.PROBE_SLOTS]
            self._probe_unfetched = self._probe_unfetched[self.PROBE_SLOTS:]
            vec = torch.cat([torch.stack([o[0] for o in outs]).reshape(-1)]
                            + [p for _, p in probes])
            event = None
            if dev.type == "cuda":
                host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
                host.copy_(vec, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = vec
            self._pending.append(_Chunk([b[1] for b in buf], [b[2] for b in buf], outs,
                                        [k for k, _ in probes], host, event))

    def _finalize_impl(self, drain: bool):
        """Consume chunks (reference :1065-1158): with `drain`, all of them
        and every unread probe; else those whose copy has landed, plus the
        oldest ones while more than `pipeline` frames are in flight (the
        backpressure: the host waits for the oldest). Probes first (each
        predates its chunk's frames); a correction's rigid delta is composed
        in float64 onto every pack read with it, and then every chunk still
        in flight is read too (a GBA merge that landed while a chunk was in
        flight has its delta composed first). One threshold-controller step
        per batch, on the median feature count; then the frames in order. A
        loss drops everything still in flight."""
        if not self._pending and not (drain and self._probe_unfetched):
            return
        with self._map_lock, self.timer.stage("pipeline_finalize"):
            if drain:
                recs, self._pending = self._pending, []
            else:
                recs = []
                while self._pending and self._pending[0].done():
                    recs.append(self._pending.pop(0))
                while self._pending and \
                        sum(len(r.ts) for r in self._pending) > max(self.pipeline, 1):
                    recs.append(self._pending.pop(0))
            if not recs and not (drain and self._probe_unfetched):
                return
            splits = [r.read() for r in recs]
            probe_list = [p for _, ps in splits for p in ps]
            if drain and self._probe_unfetched:
                # probes with no chunk left to ride: read directly
                left, self._probe_unfetched = self._probe_unfetched, []
                probe_list += [(k, h.cpu().numpy()) for k, h in left]
            deltas = self._consume_probes(probe_list)
            if deltas and self._pending:
                more, self._pending = self._pending, []
                more_splits = [r.read() for r in more]
                deltas += self._consume_probes([p for _, ps in more_splits for p in ps])
                recs += more
                splits += more_splits
            if not recs:
                return
            packs = np.concatenate([pk for pk, _ in splits])
            # one controller step per batch: its frames all saw one threshold
            self.threshold.update(int(np.median(packs[:, 0])))
            row = 0
            for rec in recs:                  # GBA merges while in flight
                for dR, dt in rec.moves:
                    _compose_rows(packs[row:row + len(rec.ts)],
                                  dR.cpu().numpy().astype(np.float64),
                                  dt.cpu().numpy().astype(np.float64))
                row += len(rec.ts)
            for dR, dt in deltas:             # then this batch's loop corrections
                _compose_rows(packs, dR, dt)
            prev_pose = None
            row = 0
            for rec in recs:
                for c in range(len(rec.ts)):
                    v = packs[row + c]
                    if not self._consume_record(rec, c, v, prev_pose):
                        self._pending = []
                        return
                    prev_pose = (v[4:13].reshape(3, 3), v[13:16])
                row += len(rec.ts)

    def _consume_record(self, rec: _Chunk, c: int, v: np.ndarray, prev_pose) -> bool:
        """Host policy for one lagged frame (reference :1160-1196). Returns
        False on a loss: RECENTLY_LOST, the velocity reset, the chain and
        the buffered frames dropped (counted in `frames_skipped`)."""
        ts, fid = rec.ts[c], rec.fids[c]
        n_inl, n_close_t, n_close_u = int(v[1]), int(v[2]), int(v[3])
        R = v[4:13].reshape(3, 3).astype(np.float32)
        t = v[13:16].astype(np.float32)
        if n_inl < self.cfg.tracker.min_inliers:
            self.stats["track_fail"] += 1
            self.state = RECENTLY_LOST
            self.lost_since = ts
            self.vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
            self._chain = None
            self.stats["frames_skipped"] += len(self._img_buf)
            self._img_buf = []
            return False
        self.pose = (R, t)
        if prev_pose is not None:
            Rp, tp = prev_pose
            Rv = R @ Rp.T
            self.vel = (Rv.astype(np.float32), (t - Rv @ tp).astype(np.float32))
        self.trajectory.append((ts, R, t))
        self.n_inliers_last = n_inl
        if self._need_new_keyframe_scalars(n_inl, n_close_t, n_close_u, fid):
            self._create_keyframe_from_record(rec, c, R, t, n_inl)
        return True

    def _drain_pipeline(self):
        """Dispatch the buffered frames and consume everything in flight
        (before any synchronous logic); the chain restarts."""
        if self._img_buf:
            self._dispatch_chunk()
        if self._pending or self._probe_unfetched:
            self._finalize_impl(drain=True)
        self._chain = None

    def finish(self):
        """Flush the pipeline and wait for the mapper's queue and a running
        GBA (the end of a sequence, before reading the trajectory)."""
        with self._counting_pose_evals():
            self._drain_pipeline()
        self.wait_mapping_idle()
        self.wait_gba()

    # -- the mapper thread (reference :1747-1786, 1851-1857) ------------------
    @property
    def _in_mapper_thread(self) -> bool:
        return threading.current_thread() is self._mapper_thread

    def _record_error(self, counter: str, what: str):
        """A thread's caught failure: counted in stats[counter], its
        traceback kept in `self.errors` and written to stderr."""
        self.stats[counter] += 1
        msg = f"[tracker] {counter}: {what}\n{traceback.format_exc()}"
        self.errors.append(msg)
        print(msg, file=sys.stderr, flush=True)

    def _mapper_loop(self):
        """LocalMapping / LoopClosing on their own thread: one keyframe id at
        a time from the queue, under `_map_lock`. A detached queue (None)
        leaves the mapping inline; an exception is counted and the thread
        goes on (reference :1770-1771)."""
        with on_device(self.device):
            while not self._mapper_stop:
                q = self._map_queue
                if q is None:
                    time.sleep(0.05)
                    continue
                try:
                    epoch, kid = q.get(timeout=0.05)
                except queue.Empty:
                    continue
                try:
                    with self._map_lock:
                        if epoch == self._map_epoch:
                            self._mapping_pipeline(kid, lagged_loops=self.pipeline > 1)
                except Exception:
                    self._record_error("mapper_errors", f"keyframe {kid}")
                finally:
                    q.task_done()

    def wait_mapping_idle(self, timeout: float = 60.0):
        """Block until the mapper's queue is done; raises TimeoutError
        after `timeout` s."""
        q = self._map_queue
        if q is None or self._mapper_thread is None:
            return
        t0 = time.monotonic()
        while q.unfinished_tasks > 0:
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"the mapper thread is still busy after {timeout} s")
            time.sleep(0.005)

    def shutdown_mapping(self):
        """Wait for a running GBA and for the mapper's queue, then stop and
        join the mapper thread; later keyframes are mapped inline."""
        self.wait_gba()
        t = self._mapper_thread
        if t is not None:
            self.wait_mapping_idle()
            self._mapper_stop = True
            t.join(timeout=60.0)
            if t.is_alive():
                raise RuntimeError("the mapper thread did not stop")
            self._mapper_thread = None
            self._map_queue = None

    # -- the asynchronous global BA (reference :1789-1849) --------------------
    def _maybe_start_gba(self, frame: Optional[int] = None):
        """With `async_gba`, start the post-loop global BA on its own thread
        (mpThreadGBA, LoopClosing.cc:1198), after aborting a running one (a
        newer loop supersedes it). It optimises a snapshot of the map taken
        now, in one-iteration chunks with its abort polled, and merges under
        a lock acquired by polling, so an abort can never deadlock against
        it; `_after_merge` then moves the tracker's poses with the map.
        `frame`: the id of the frame whose loop started it, for its span."""
        lc = self.loop_closer
        if lc is None or not lc.async_gba or lc.gba_iters <= 0:
            return
        self._abort_gba_and_join()
        m0 = ms.clone_map(self.map)
        n_kf0 = self._n_kf_host
        abort = threading.Event()
        cfg = self.cfg

        def run():
            with on_device(self.device), self.timer.span("loop.gba_thread", frame=frame):
                try:
                    m_gba = global_bundle_adjust_auto(
                        m0, self.cam_params, bf=float(cfg.bf), cam_model=cfg.camera.model_id,
                        n_iters=lc.gba_iters, chunk=1, n_ba_points=min(m0.max_mp, 4096),
                        should_abort=abort.is_set)
                    merged = False
                    while not merged and not abort.is_set():
                        if self._map_lock.acquire(timeout=0.02):
                            try:
                                if not abort.is_set():
                                    k = self.last_kf_id
                                    before = (self.map.kf_R[k], self.map.kf_t[k])
                                    self.map = merge_gba_result(
                                        self.map, m_gba.kf_R, m_gba.kf_t, m_gba.mp_pos,
                                        n_kf0, self._n_kf_host, m0.mp_valid, m0.mp_first_kf)
                                    if k >= 0:
                                        self._after_merge(k, *before)
                                    merged = True
                            finally:
                                self._map_lock.release()
                    self.stats["n_gba_merged" if merged else "n_gba_aborted"] += 1
                except Exception:
                    self._record_error("gba_errors", "global BA")

        self.stats["n_gba_started"] += 1
        self._gba_abort = abort
        self._gba_thread = threading.Thread(target=run, daemon=True)
        self._gba_thread.start()

    def _after_merge(self, k: int, R_old, t_old):
        """A merged GBA moved the map: the tracker's pose, the pipelined
        chain and every chunk in flight move with the last keyframe `k`
        (its pose before the merge, R_old / t_old, and after), keeping their
        pose relative to it, as ORB-SLAM3 keeps the last frame's pose
        relative to its reference keyframe (Tracking::UpdateLastFrame). The
        chain goes on, bindings and all, in the merged map; nothing is read
        back. The reference drops its chain instead (:1825), so that the next
        chunk starts without bindings from a pose of the world before the
        merge; it never meets this on its pipelined path, whose keyframes
        abort the GBA before it merges."""
        R_new, t_new = self.map.kf_R[k], self.map.kf_t[k]
        dR = R_old.T @ R_new
        dt = R_old.T @ (t_new - t_old)
        if self._chain is not None:
            R, t = self._chain[:2]
            self._chain = (R @ dR, R @ dt + t) + tuple(self._chain[2:])
        if self.pose is not None:
            R, t = (self._dev(x) for x in self.pose)
            self.pose = (R @ dR, R @ dt + t)
        for rec in self._pending:
            rec.moves.append((dR, dt))

    def _abort_gba_and_join(self, timeout: float = 60.0):
        """Abort and join a running GBA; its result is discarded."""
        t = self._gba_thread
        if t is not None:
            self._gba_abort.set()
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError("the aborted GBA thread did not stop")
        self._gba_thread = None

    def wait_gba(self, timeout: float = 300.0):
        """Wait for a running GBA to finish and merge."""
        t = self._gba_thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(f"the GBA thread is still running after {timeout} s")
            self._gba_thread = None

    def trajectory_centers(self) -> np.ndarray:
        """(T, 3) camera centres of the tracked frames."""
        out = [-R.T @ t for _, R, t in self.trajectory]
        return np.stack(out) if out else np.zeros((0, 3))

    def trajectory_poses(self) -> list:
        """[(timestamp, (R, t))] of the tracked frames, world to camera."""
        return [(ts, (R, t)) for ts, R, t in self.trajectory]


class StereoTracker(Tracker):
    """`Tracker(cfg, "stereo", ...)` with loop closing off unless asked for
    (the reference's alias, tracker.py:2329-2333)."""

    def __init__(self, cfg: SlamConfig, **kw):
        kw.setdefault("enable_loop_closing", False)
        super().__init__(cfg, sensor="stereo", **kw)
