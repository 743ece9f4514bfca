"""Relocalisation paths (port of `orbslam3lib_tpu/tracking/reloc.py:159-190`).

Only TrackReferenceKeyFrame is ported so far: it is the fallback the
tracker takes every time a frame's inliers fall below `min_inliers`, and it
reaches kernel 2 through `match_descriptors_ratio`. BoW candidate retrieval
and P6P relocalisation come with the relocalisation port.
"""
from __future__ import annotations

import torch

from ..mapping.map_ba import inv_sigma2
from ..models.map_state import MapState
from ..utils import cameras
from .matching import match_descriptors_ratio, rotation_consistency
from .pose_opt import PoseObs, pose_optimization


def track_reference_kf(m: MapState, kf_id: int, R0, t0, feat_xy, feat_level,
                       feat_desc, feat_valid, feat_angle, u_right, depth,
                       cam_params, cam_model: int = cameras.PINHOLE,
                       bf: float = 0.0, n_levels: int = 8):
    """TrackReferenceKeyFrame (Tracking.cc:2778): match the frame to the
    reference keyframe's landmark-bearing features (ratio 0.7, TH_LOW,
    rotation histogram) and pose-optimise from the last frame's pose.
    Returns (R, t, n_inliers)."""
    k = min(max(int(kf_id), 0), m.max_kf - 1)
    F = feat_desc.shape[0]
    P = m.max_mp
    kf_has_mp = (m.kf_mp[k] >= 0) & m.kf_feat_valid[k]
    idx, ok = match_descriptors_ratio(feat_desc, feat_valid, m.kf_desc[k],
                                      kf_has_mp, th=50.0, ratio=0.7)
    idx_c = torch.clamp(idx, 0, F - 1).long()
    ok = rotation_consistency(feat_angle, m.kf_angle[k][idx_c], ok)
    mp_ids = m.kf_mp[k][idx_c]
    mp_ids_c = torch.clamp(mp_ids, 0, P - 1).long()
    good = ok & (mp_ids >= 0) & m.mp_valid[mp_ids_c]
    obs = PoseObs(p_world=m.mp_pos[mp_ids_c],
                  uv=feat_xy,
                  inv_sigma2=inv_sigma2(feat_level, n_levels),
                  u_right=torch.where(depth > 0, u_right, torch.zeros_like(u_right)),
                  is_stereo=good & (depth > 0),
                  valid=good)
    R, t, _, n_inl = pose_optimization(R0, t0, obs, cam_params,
                                       cam_model=cam_model, bf=bf)
    return R, t, n_inl
