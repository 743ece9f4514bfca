"""Relocalisation paths and the keyframe database (port of
`orbslam3lib_tpu/tracking/reloc.py`).

TrackReferenceKeyFrame, the fallback the tracker takes every time a
frame's inliers fall below `min_inliers`; BoW relocalisation
(Tracking::Relocalization, Tracking.cc:3670: DetectRelocalizationCandidates
-> descriptor matching -> PnP RANSAC -> pose optimisation -> projection
refine), with the reference's batched P6P DLT sweep in place of MLPnP's
sequential RANSAC; and the dense BoW keyframe database `PlaceRecognition`,
which the back end fills on every keyframe. The descriptor matching of
both paths is kernel 2 on the card. The native inverted-file database is
not ported (the tracker uses the dense one, as the reference's).
"""
from __future__ import annotations

import math

import torch

from ..mapping.local_mapping import _index, _last_write, observed_mp_mask
from ..mapping.map_ba import inv_sigma2
from ..models import map_state as ms
from ..models import vocabulary as vb
from ..models.map_state import MapState
from ..ops.fast import topk_stable
from ..utils import cameras
from ..utils.sampling import ransac_indices
from ..utils.smallmat import det3
from .matching import match_descriptors_ratio, rotation_consistency, search_by_projection
from .pose_opt import PoseObs, pose_optimization


def _p6p_dlt(p3d: torch.Tensor, xy_norm: torch.Tensor):
    """[R|t] from >= 6 3D-2D correspondences in normalised coordinates, by
    DLT of the 3x4 projection matrix and orthonormalisation, batched over
    leading dims: p3d (..., S, 3), xy_norm (..., S, 2) -> (R, t).

    The null vector's sign is fixed by the points' mean depth and R = U
    diag(1, 1, det) Vt is sign-free, so LAPACK and cuSOLVER agree on
    well-posed samples."""
    X = torch.cat([p3d, torch.ones_like(p3d[..., :1])], dim=-1)    # (..., S, 4)
    zeros = torch.zeros_like(X)
    u, v = xy_norm[..., 0:1], xy_norm[..., 1:2]
    A = torch.cat([torch.cat([X, zeros, -u * X], dim=-1),
                   torch.cat([zeros, X, -v * X], dim=-1)], dim=-2)  # (..., 2S, 12)
    Vh = torch.linalg.svd(A, full_matrices=True)[2]
    P = Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 4))
    depths = torch.einsum("...sk,...k->...s", X, P[..., 2, :])
    sign = torch.where(depths.mean(dim=-1) < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    U, D, Vt = torch.linalg.svd(P[..., :3])
    ones = torch.ones_like(D[..., 0])
    R = (U * torch.stack([ones, ones, det3(U @ Vt)], dim=-1)[..., None, :]) @ Vt
    t = P[..., 3] / torch.clamp(D.mean(dim=-1), min=1e-9)[..., None]
    return R, t


def pnp_ransac(p_world, uv, valid, cam_params, cam_model: int = cameras.PINHOLE,
               n_hyp: int = 128, sample_size: int = 6,
               inlier_px: float = math.sqrt(5.991) * 2.0, seed: int = 0,
               hyp_idx=None):
    """Batched PnP RANSAC: n_hyp P6P hypotheses solved and scored against
    every correspondence at once; the first best wins. `hyp_idx` (n_hyp,
    sample_size) replaces the sampler's draws. Returns (R, t, inlier_mask,
    n_inliers)."""
    idx = ransac_indices(valid, n_hyp, sample_size, seed, hyp_idx)
    xy_norm = cameras.unproject(cam_model, cam_params, uv)[..., :2]
    Rs, ts = _p6p_dlt(p_world[idx], xy_norm[idx])                  # (H, 3, 3), (H, 3)
    p_c = torch.einsum("hij,mj->hmi", Rs, p_world) + ts[:, None, :]
    uv_hat = cameras.project(cam_model, cam_params, p_c)
    err2 = torch.sum((uv_hat - uv[None]) ** 2, dim=-1)
    ok = (err2 < inlier_px ** 2) & (p_c[..., 2] > 0.05) & valid[None, :]
    scores = ok.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(scores).reshape(1)          # gathered on the device
    return tuple(x.index_select(0, best)[0] for x in (Rs, ts, ok, scores))


def relocalize_against_kf(m: MapState, kf_id, feat_xy, feat_level, feat_desc,
                          feat_valid, feat_angle, cam_params,
                          cam_model: int = cameras.PINHOLE, img_w: int = 640,
                          img_h: int = 400, n_levels: int = 8, hyp_idx=None):
    """One relocalisation attempt against one candidate keyframe
    (Tracking::Relocalization, Tracking.cc:3670+): descriptor matching
    (ratio 0.75, TH_HIGH, rotation histogram) -> PnP RANSAC -> pose LM ->
    projection search over the candidate's landmarks (radius 10, TH_HIGH)
    -> pose LM again; the better of the two poses. Returns (R, t,
    n_inliers); the caller gates at >= 50 (nGood)."""
    dev = feat_xy.device
    k = torch.clamp(_index(kf_id, dev), 0, m.max_kf - 1).long()
    F = feat_desc.shape[0]
    P = m.max_mp
    kf_mp = ms.row(m.kf_mp, k)
    kf_has_mp = (kf_mp >= 0) & ms.row(m.kf_feat_valid, k)
    idx, ok = match_descriptors_ratio(feat_desc, feat_valid, ms.row(m.kf_desc, k),
                                      kf_has_mp, th=100.0, ratio=0.75)
    idx_c = torch.clamp(idx, 0, F - 1).long()
    ok = rotation_consistency(feat_angle, ms.row(m.kf_angle, k)[idx_c], ok)
    mp_ids = kf_mp[idx_c]
    mp_ids_c = torch.clamp(mp_ids, 0, P - 1).long()
    good = ok & (mp_ids >= 0) & m.mp_valid[mp_ids_c]
    p_w = m.mp_pos[mp_ids_c]

    ones, zeros = torch.ones(F, device=dev), torch.zeros(F, device=dev)
    no_stereo = torch.zeros(F, dtype=torch.bool, device=dev)
    R0, t0, inl, _ = pnp_ransac(p_w, feat_xy, good, cam_params, cam_model=cam_model,
                                hyp_idx=hyp_idx)
    obs = PoseObs(p_world=p_w, uv=feat_xy, inv_sigma2=ones, u_right=zeros,
                  is_stereo=no_stereo, valid=good & inl)
    R1, t1, _, n1 = pose_optimization(R0, t0, obs, cam_params, cam_model=cam_model)

    # projection refine (Tracking.cc:3744+): the candidate's landmarks in a
    # 10 px window, then re-optimise
    pm = search_by_projection(
        m.mp_pos, m.mp_desc, observed_mp_mask(m, k.reshape(1)), m.mp_normal,
        m.mp_min_dist, m.mp_max_dist, R1, t1, cam_params, feat_xy, feat_level,
        feat_desc, feat_valid, radius=10.0, cam_model=cam_model, img_w=img_w,
        img_h=img_h, th_desc=100.0, n_levels=n_levels)
    # feature -> landmark; where two landmarks hold one feature the higher
    # id wins, the write XLA on the CPU keeps
    src = _last_write(torch.where(pm.mp_feat >= 0, pm.mp_feat, F), F)
    obs2 = PoseObs(p_world=m.mp_pos[torch.clamp(src, 0, P - 1)], uv=feat_xy,
                   inv_sigma2=ones, u_right=zeros, is_stereo=no_stereo, valid=src >= 0)
    R2, t2, _, n2 = pose_optimization(R1, t1, obs2, cam_params, cam_model=cam_model)
    use2 = n2 > n1
    return (torch.where(use2, R2, R1), torch.where(use2, t2, t1),
            torch.maximum(n1, n2))


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


def detect_reloc_candidates(m: MapState, bow_db, active, q, n_best: int = 3,
                            n_covis: int = 10):
    """KeyFrameDatabase::DetectRelocalizationCandidates: keyframes sharing
    >= 0.8x the most common words with the query; each candidate's score
    accumulated over its n_covis best covisible neighbours; groups under
    0.75x the best accumulated score dropped; each surviving group
    represented by its best-scoring member. Ties keep the lower id first,
    as `lax.top_k`. Returns (ids (n_best,) int32, -1-padded; acc_scores)."""
    K = m.max_kf
    dev = bow_db.device
    s = vb.l1_scores(bow_db, q)
    common = (bow_db > 0).to(torch.float32) @ (q > 0).to(torch.float32)
    act = active & m.kf_valid
    max_c = torch.amax(torch.where(act, common, torch.zeros_like(common)))
    cand = act & (common >= 0.8 * max_c) & (common > 0)
    s_c = torch.where(cand, s, torch.zeros_like(s))

    C = ms.covisibility(m) * (1.0 - torch.eye(K, device=dev))
    top_w, top_i = topk_stable(C, n_covis)                     # best covisibles per KF
    nb_ok = (top_w > 0).to(torch.float32)
    acc = s_c + torch.sum(s_c[top_i] * nb_ok, dim=1)
    acc = torch.where(cand, acc, torch.full_like(acc, -1.0))
    keep = cand & (acc >= 0.75 * torch.amax(acc))

    grp = torch.cat([torch.arange(K, device=dev)[:, None], top_i], dim=1)
    grp_s = torch.cat([s_c[:, None], s_c[top_i] * nb_ok], dim=1)
    best_member = grp[torch.arange(K, device=dev), torch.argmax(grp_s, dim=1)]
    top_acc, top_gi = topk_stable(torch.where(keep, acc, torch.full_like(acc, -1.0)), n_best)
    ids = torch.where(top_acc > 0, best_member[top_gi], -1)
    return ids.to(torch.int32), top_acc


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
