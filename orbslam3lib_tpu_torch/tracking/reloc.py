"""Relocalisation paths and the keyframe database (port of
`orbslam3lib_tpu/tracking/reloc.py:159-190, 239-285`).

Ported so far: TrackReferenceKeyFrame, the fallback the tracker takes every
time a frame's inliers fall below `min_inliers` (it reaches kernel 2
through `match_descriptors_ratio`), and the dense BoW keyframe database
`PlaceRecognition`, which the back end fills on every keyframe. P6P
relocalisation, `detect_reloc_candidates` and the native inverted-file
database come with the relocalisation port.
"""
from __future__ import annotations

import torch

from ..mapping.map_ba import inv_sigma2
from ..models import vocabulary as vb
from ..models.map_state import MapState
from ..ops.fast import topk_stable
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


def make_place_recognition(voc: vb.Vocabulary, max_kf: int) -> "PlaceRecognition":
    """The keyframe database the tracker uses: the dense one (the reference
    calls its factory with `prefer_native=False`, tracker.py:653)."""
    return PlaceRecognition(voc, max_kf)


class PlaceRecognition:
    """Dense BoW keyframe database (the KeyFrameDatabase equivalent): a
    (max_kf, W) tf-idf matrix on the vocabulary's device; add() on keyframe
    insertion, query() returns the top-N keyframes by DBoW2 L1 score."""

    def __init__(self, voc: vb.Vocabulary, max_kf: int):
        self.voc = voc
        dev = voc.idf.device
        self.bow_db = torch.zeros((max_kf, voc.n_words), dtype=torch.float32, device=dev)
        self.active = torch.zeros(max_kf, dtype=torch.bool, device=dev)

    def add(self, kf_id: int, desc_bits, valid):
        self.bow_db[kf_id] = vb.bow_from_descriptors(self.voc, desc_bits, valid)
        self.active[kf_id] = True

    def query(self, desc_bits, valid, exclude_mask=None, n_best: int = 3):
        """Returns (ids (n_best,), scores (n_best,)), best first; equal scores
        keep the lower keyframe id first (the order of `lax.top_k`)."""
        q = vb.bow_from_descriptors(self.voc, desc_bits, valid)
        s = vb.l1_scores(self.bow_db, q)
        s = torch.where(self.active, s, torch.full_like(s, -1.0))
        if exclude_mask is not None:
            s = torch.where(exclude_mask, torch.full_like(s, -1.0), s)
        top_s, top_i = topk_stable(s, n_best)
        return top_i, top_s
