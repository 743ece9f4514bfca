"""Loop detection and correction over the tensor map, and the per-keyframe
mapper step (port of `orbslam3lib_tpu/mapping/loop_closing.py`).

The reference's LoopClosing thread (LoopClosing.cc: NewDetectCommonRegions
:324, DetectCommonRegionsFromBoW :583-800, CorrectLoop :969) in the
synchronous form: `mapper_step_fused` adds the keyframe's BoW vector, runs
local mapping and the loop-candidate probe (`loop_probe`) as one queue of
device work; the host reads the probe's 16-float pack and `LoopCloser`
applies the temporal-consistency state machine. On a consistent candidate
`verify_loop_fused` runs the whole geometric cascade (descriptor matching,
kernel 2 on the card; Sim3 RANSAC; neighbourhood reprojection;
SearchBySim3; OptimizeSim3) into one 24-float pack, read once; the host
gate ladder decides, and `LoopCloser.correct` optimises the essential graph
and re-anchors the landmarks, followed by a global BA.

Functions take keyframe ids as Python ints or 0-d tensors; none reads a
value back to the host. With `cfg.mapping.async_gba` the global BA does
not run inside `on_probe_result`: the tracker starts it on a thread of its
own.

`MapMerger` is the merge branch of NewDetectCommonRegions (LoopClosing.cc
:324) and MergeLocal (:1215) across the Atlas's maps: every keyframe of
the current map queries the frozen BoW databases of the archived maps;
three consistent hits, the cross-map match (`match_kf_landmarks_cross`,
kernel 2 on the card), Sim3 RANSAC and OptimizeSim3 verify it, and the
archived map is welded into the current one (`models/atlas.Atlas.merge`
through `merge_world_sim3`), followed by a BA over the seam. Once the
tracker's IMU is initialised (`MapMerger.inertial`) the weld is yaw-only
with scale 1 and the scale gate [0.9, 1.1] (MergeLocal2), and the archived
map's preintegration registry comes back with it for the tracker's
MergeInertialBA.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import to_device
from ..models import map_state as ms
from ..models.vocabulary import _descend, bow_from_descriptors, bow_vector, l1_scores
from ..ops.fast import topk_stable
from ..ops.masks import is_finite_match, leq_int, penalize, step01
from ..ops.matcher import hamming_matrix
from ..ops.pyramid import scale_factors_on
from ..tracking.matching import (TH_HIGH, match_descriptors_ratio,
                                 predicted_level, search_by_projection)
from ..utils import cameras, lie
from . import pose_graph
from . import sim3 as sim3_mod
from .local_mapping import _index, mapping_step, observed_mp_mask, top_covisible
from .map_ba import global_bundle_adjust, map_window_ba


def _kf(m: ms.MapState, k) -> torch.Tensor:
    """A keyframe id clamped into the map, as a 0-d int64 device tensor."""
    return torch.clamp(_index(k, m.kf_R.device), 0, m.max_kf - 1).long()


def match_kf_landmarks(m: ms.MapState, kf_a, kf_b):
    """Descriptor-match the landmark-bearing features of two keyframes
    (SearchByBoW(KF, KF) and the Sim3Solver input, LoopClosing.cc:578+):
    kNN-2 with ratio 0.9 under 75 bits (kernel 2 on the card).

    Returns (p_a_cam (F, 3), p_b_cam (F, 3), uv_a, uv_b, valid, idx)
    aligned to kf_a's feature slots; idx is the matched kf_b slot or -1."""
    return _match_landmarks(m, kf_a, m, kf_b)


def match_kf_landmarks_cross(ma: ms.MapState, kf_a, mb: ms.MapState, kf_b):
    """`match_kf_landmarks` across two maps: keyframe kf_a of `ma` against
    keyframe kf_b of `mb` (the merge branch's geometric input,
    LoopClosing.cc:324+). Returns (p_a_cam, p_b_cam, uv_a, uv_b, valid)."""
    return _match_landmarks(ma, kf_a, mb, kf_b)[:5]


def _match_landmarks(ma: ms.MapState, kf_a, mb: ms.MapState, kf_b):
    a, b = _kf(ma, kf_a), _kf(mb, kf_b)
    F = ma.n_feat
    mp_row_a, mp_row_b = ms.row(ma.kf_mp, a), ms.row(mb.kf_mp, b)
    has_a = ms.row(ma.kf_feat_valid, a) & (mp_row_a >= 0)
    has_b = ms.row(mb.kf_feat_valid, b) & (mp_row_b >= 0)
    idx, ok = match_descriptors_ratio(ms.row(ma.kf_desc, a), has_a,
                                      ms.row(mb.kf_desc, b), has_b, th=75.0, ratio=0.9)
    idx_c = torch.clamp(idx, 0, F - 1).long()
    mp_a = torch.clamp(mp_row_a, 0, ma.max_mp - 1).long()
    mp_b = torch.clamp(mp_row_b[idx_c], 0, mb.max_mp - 1).long()
    valid = ok & ma.mp_valid[mp_a] & mb.mp_valid[mp_b]
    p_a = lie.se3_apply(ms.row(ma.kf_R, a), ms.row(ma.kf_t, a), ma.mp_pos[mp_a])
    p_b = lie.se3_apply(ms.row(mb.kf_R, b), ms.row(mb.kf_t, b), mb.mp_pos[mp_b])
    return (p_a, p_b, ms.row(ma.kf_xy, a), ms.row(mb.kf_xy, b)[idx_c], valid,
            torch.where(valid, idx, -1))


def merge_world_sim3(R_cur, t_cur, R12, t12, s12, R_old, t_old):
    """The world-frame Sim3 (current map's world <- old map's world) from a
    camera-frame one S12 (old keyframe's camera -> current keyframe's):
    S_w = T_cw_cur^-1 o S12 o T_cw_old."""
    one = torch.ones((), dtype=torch.float32, device=R_cur.device)
    Ri, ti, si = lie.sim3_inverse(R_cur, t_cur, one)
    Rm, tm, sm = lie.sim3_compose(R12, t12, s12, R_old, t_old, one)
    return lie.sim3_compose(Ri, ti, si, Rm, tm, sm)


def _sim3_project_match(p_in_tgt, src_ok, src_desc, src_min_dist, src_max_dist,
                        xy_t, lvl_t, desc_t, ok_t, cam_params, cam_model: int,
                        img_w: int, img_h: int, n_levels: int, radius: float):
    """One direction of ORBmatcher::SearchBySim3: project the source
    landmarks (already in the target camera) and match each to the best
    target feature inside the scale-predicted radius. Returns the matched
    target slot per source slot (-1 = none)."""
    z = p_in_tgt[..., 2]
    uv = cameras.project(cam_model, cam_params, p_in_tgt)
    dist = torch.linalg.norm(p_in_tgt, dim=-1)
    vis = src_ok.to(torch.float32) * step01((z - 0.1) * 10.0)
    vis = vis * step01(uv[..., 0] + 1.0) * step01(img_w - uv[..., 0])
    vis = vis * step01(uv[..., 1] + 1.0) * step01(img_h - uv[..., 1])
    # scale-invariance band (ORBmatcher.cc:1464: minDistance <= d <= maxDistance)
    vis = vis * step01((dist - 0.8 * src_min_dist) * 8.0)
    vis = vis * step01((1.2 * src_max_dist - dist) * 8.0)
    lvl = predicted_level(dist, src_max_dist, n_levels)
    r_scaled = radius * scale_factors_on(n_levels, uv.device)[lvl.long()]

    d2 = torch.sum((uv[:, None, :] - xy_t[None, :, :]) ** 2, dim=-1)
    g = step01(r_scaled[:, None] ** 2 - d2 + 1.0)
    dlvl = torch.abs(lvl_t[None, :] - lvl[:, None]).to(torch.float32)
    g = g * step01(2.0 - dlvl)
    g = g * vis[:, None] * ok_t.to(torch.float32)[None, :]
    dm = hamming_matrix(src_desc, desc_t)
    dm = penalize(dm, g * leq_int(dm, TH_HIGH))
    best = torch.argmin(dm, dim=1)
    hasm = is_finite_match(torch.amin(dm, dim=1))
    return torch.where(hasm > 0.5, best, -1)


def search_by_sim3(m: ms.MapState, kf_a, kf_b, R12, t12, s12, cam_params,
                   prev_idx, prev_ok, cam_model: int = 0, img_w: int = 640,
                   img_h: int = 400, n_levels: int = 8, radius: float = 7.5):
    """Grow the loop correspondences through the estimated Sim3
    (ORBmatcher::SearchBySim3, ORBmatcher.cc:1464): kf_a's landmarks into
    kf_b through S21 and kf_b's into kf_a through S12, mutual agreements
    become new matches; slots matched already (prev_idx / prev_ok) keep
    theirs. S12: p_a_cam ~ s12 R12 p_b_cam + t12.

    Returns (p_a_cam, p_b_cam, uv_a, uv_b, valid) aligned to kf_a's slots."""
    a, b = _kf(m, kf_a), _kf(m, kf_b)
    F, P = m.n_feat, m.max_mp
    row_a, row_b = ms.row(m.kf_mp, a), ms.row(m.kf_mp, b)
    mp_a = torch.clamp(row_a, 0, P - 1).long()
    mp_b = torch.clamp(row_b, 0, P - 1).long()
    has_a = ms.row(m.kf_feat_valid, a) & (row_a >= 0) & m.mp_valid[mp_a]
    has_b = ms.row(m.kf_feat_valid, b) & (row_b >= 0) & m.mp_valid[mp_b]
    p_a_cam = lie.se3_apply(ms.row(m.kf_R, a), ms.row(m.kf_t, a), m.mp_pos[mp_a])
    p_b_cam = lie.se3_apply(ms.row(m.kf_R, b), ms.row(m.kf_t, b), m.mp_pos[mp_b])

    p_b_in_a = s12 * (p_b_cam @ R12.T) + t12
    Ri, ti, si = lie.sim3_inverse(R12, t12, s12)
    p_a_in_b = si * (p_a_cam @ Ri.T) + ti
    xy_a, xy_b = ms.row(m.kf_xy, a), ms.row(m.kf_xy, b)
    desc_a, desc_b = ms.row(m.kf_desc, a), ms.row(m.kf_desc, b)
    kw = (cam_params, cam_model, img_w, img_h, n_levels, radius)
    match_ab = _sim3_project_match(p_a_in_b, has_a, desc_a, m.mp_min_dist[mp_a],
                                   m.mp_max_dist[mp_a], xy_b, ms.row(m.kf_level, b),
                                   desc_b, has_b, *kw)
    match_ba = _sim3_project_match(p_b_in_a, has_b, desc_b, m.mp_min_dist[mp_b],
                                   m.mp_max_dist[mp_b], xy_a, ms.row(m.kf_level, a),
                                   desc_a, has_a, *kw)
    j = torch.clamp(match_ab, 0, F - 1)
    mutual = (match_ab >= 0) & (match_ba[j] == torch.arange(F, device=j.device))
    use_new = mutual & has_a & has_b[j] & ~prev_ok
    idx_out = torch.where(prev_ok, torch.clamp(prev_idx, 0, F - 1).long(),
                          torch.where(use_new, j, 0))
    return p_a_cam, p_b_cam[idx_out], xy_a, xy_b[idx_out], prev_ok | use_new


def project_count_sim3(m: ms.MapState, kf_cur, kf_loop, R12, t12, s12,
                       cam_params, cam_model: int = 0, img_w: int = 640,
                       img_h: int = 400, n_levels: int = 8,
                       radius: float = 8.0, n_covis: int = 10):
    """Projection matches of the loop neighbourhood into the current
    keyframe through the candidate Sim3 (the verification SearchByProjection
    of DetectCommonRegionsFromBoW, LoopClosing.cc:755/791): the landmarks of
    the loop keyframe and its 10 best covisible neighbours, projected through
    S12 o T_loop_w with the world pre-scaled by s12. Counts distinct matched
    features (0-d int32)."""
    nbrs = top_covisible(m, kf_loop, n_covis)
    ids = torch.cat([nbrs, _index(kf_loop, nbrs.device).reshape(1)])
    mask = observed_mp_mask(m, ids)
    l, c = _kf(m, kf_loop), _kf(m, kf_cur)
    R_cw = R12 @ ms.row(m.kf_R, l)
    t_cw = s12 * (R12 @ ms.row(m.kf_t, l)) + t12
    # landmarks without a stored normal pass the view-angle gate
    cw = -(R_cw.T @ t_cw)                                      # scaled-world centre
    view = m.mp_pos * s12 - cw
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True), min=1e-9)
    has_n = torch.linalg.norm(m.mp_normal, dim=-1) > 1e-6
    normal = torch.where(has_n[:, None], m.mp_normal, view)
    pm = search_by_projection(
        m.mp_pos * s12, m.mp_desc, mask, normal, m.mp_min_dist * s12,
        m.mp_max_dist * s12, R_cw, t_cw, cam_params, ms.row(m.kf_xy, c),
        ms.row(m.kf_level, c), ms.row(m.kf_desc, c), ms.row(m.kf_feat_valid, c),
        radius, cam_model=cam_model, img_w=img_w, img_h=img_h, n_levels=n_levels)
    # distinct matched features (nProjMatches counts feature slots);
    # index_fill_, not `hit[tgt] = True`, which would wait for the card
    F = m.n_feat
    tgt = torch.where(pm.mp_feat >= 0, pm.mp_feat, F).long()
    hit = torch.zeros(F + 1, dtype=torch.bool, device=tgt.device).index_fill_(0, tgt, True)
    return hit[:F].sum(dtype=torch.int32)


def essential_edges(m: ms.MapState, e_max: int = 1024, min_weight: float = 100.0):
    """Essential-graph edges (OptimizeEssentialGraph input, Optimizer.cc:1511):
    the e_max heaviest pairs among the sequential chain and the strong
    covisibility links (weight >= 100), then the spanning tree. The caller
    appends the loop edges. Returns (e_i, e_j, e_valid), static size
    min(e_max, K^2) + K; equal weights keep the lower pair index first, as
    `lax.top_k`."""
    K = m.max_kf
    dev = m.kf_R.device
    e_max = min(e_max, K * K)
    C = ms.covisibility(m)
    ii = torch.arange(K, device=dev)[:, None].expand(K, K)
    jj = torch.arange(K, device=dev)[None, :].expand(K, K)
    upper = step01((jj - ii).to(torch.float32))
    seq = upper * step01(1.0 - torch.abs(jj - ii - 1).to(torch.float32))
    kv = m.kf_valid.to(torch.float32)
    w = (C * step01(C - min_weight + 1.0) + seq * 1e6) * upper * (kv[:, None] * kv[None, :])
    top_w, top_idx = topk_stable(w.reshape(-1), e_max)
    par = m.kf_parent
    par_c = torch.clamp(par, 0, K - 1)
    tree_valid = (par >= 0) & m.kf_valid & m.kf_valid[par_c.long()]
    e_i = torch.cat([(top_idx // K).to(torch.int32), par_c.to(torch.int32)])
    e_j = torch.cat([(top_idx % K).to(torch.int32),
                     torch.arange(K, dtype=torch.int32, device=dev)])
    return e_i, e_j, torch.cat([top_w > 0, tree_valid])


def apply_pose_graph_result(m: ms.MapState, new_R, new_t, new_s, old_R, old_t,
                            scale_points: bool = False):
    """Write the corrected poses back (Sim3 -> SE3 with t / s, CorrectLoop
    LoopClosing.cc:1035) and re-anchor every landmark through its first
    observer, its point in that keyframe's camera taken through the
    corrected Sim3's inverse: p' = S_new^-1 (Tcw_old p) = R^T (p_c / s -
    t / s) (LoopClosing.cc:1005-1020), with `scale_points`; without it the
    camera-frame point keeps its depth, p' = R^T (p_c - t / s), which is
    the same where s is 1 (a scale-fixed closer). In place; returns the
    map.

    The reference's function (loop_closing.py:437-453) never divides by s,
    so a free-scale (monocular) correction moves the keyframes to the new
    scale and leaves their landmarks at the old one (ROADMAP queue 3);
    `LoopCloser.correct` scales them when its scale is free."""
    se3_t = new_t / torch.clamp(new_s[:, None], min=1e-9)
    ref = torch.clamp(m.mp_first_kf, 0, m.max_kf - 1).long()
    has_ref = (m.mp_first_kf >= 0) & m.mp_valid
    p_cam = lie.se3_apply(old_R[ref], old_t[ref], m.mp_pos)
    if scale_points:
        p_cam = p_cam / torch.clamp(new_s[ref][:, None], min=1e-9)
    p_new = lie._matvec(new_R[ref].transpose(-1, -2), p_cam - se3_t[ref])
    h = has_ref.to(torch.float32)[:, None]
    m.mp_pos = h * p_new + (1.0 - h) * m.mp_pos
    m.kf_R, m.kf_t = new_R, se3_t
    return m


def loop_probe(m: ms.MapState, bow_db, active, centroids, idf, kf_id,
               k: int, depth: int, n_best: int = 3, prev_cand=None):
    """The per-keyframe loop-candidate probe: covisibility row, BoW descent,
    exclusions and the top n_best candidates, and the BoW-match count of
    the best one (kernel 2 on the card).

    Returns a (3 n_best + 2,) f32 pack [ids | scores | covis_w | min_score |
    n_bow]. covis_w is each candidate's covisibility with `prev_cand` (the
    previous consistent candidate) when given, else with the keyframe: the
    reference's consistency test compares candidate groups
    (LoopClosing.cc:396+). Excluded: culled keyframes, covisible ones, the
    8 nearest ids and keyframes within 2 s."""
    dev = bow_db.device
    K = m.max_kf
    kf = _kf(m, kf_id)
    O = ms.observation_matrix(m)
    covis_row = O @ ms.row(O, kf)
    words = _descend(centroids, ms.row(m.kf_desc, kf), k, depth)
    q = bow_vector(words, ms.row(m.kf_feat_valid, kf), idf, k ** depth)
    s = l1_scores(bow_db, q)
    ii = torch.arange(K, device=dev)
    active = active & m.kf_valid
    # dynamic score floor: the worst covisible neighbour's score (DetectLoop)
    covis_mask = (covis_row >= 15.0) & active & (ii != kf)
    min_score = torch.where(torch.any(covis_mask),
                            torch.amin(torch.where(covis_mask, s, torch.ones_like(s))),
                            torch.zeros((), device=dev))
    dts = torch.abs(m.kf_ts - ms.row(m.kf_ts, kf))
    exclude = (covis_row > 0) | ~active | (torch.abs(ii - kf) <= 8) | (dts < 2.0)
    s = torch.where(exclude, torch.full_like(s, -1.0), s)
    top_s, top_i = topk_stable(s, n_best)
    if prev_cand is None:
        covis_out = covis_row[top_i]
    else:
        pc = _index(prev_cand, dev)
        covis_out = ((O @ ms.row(O, torch.clamp(pc, 0, K - 1).long()))[top_i]
                     * (pc >= 0))
    # nBoWMatches of the best candidate (the >= 20 gate, LoopClosing.cc:581)
    bow_valid = match_kf_landmarks(m, kf, top_i[0])[4]
    n_bow = bow_valid.sum().to(torch.float32)
    return torch.cat([top_i.to(torch.float32), top_s, covis_out,
                      min_score.reshape(1), n_bow.reshape(1)])


def mapper_step_fused(m: ms.MapState, bow_db, active, centroids, idf, kf_id,
                      cam_params, k: int, depth: int, n_best: int = 3,
                      cam_model: int = 0, img_w: int = 640, img_h: int = 400,
                      n_levels: int = 8, n_tri: int = 10, n_fuse: int = 3,
                      do_cull_kf: bool = True, with_probe: bool = True,
                      th_far=None, prev_cand=None):
    """The per-keyframe mapper chain (reference :527-569): ComputeBoW and
    the database add (LocalMapping::ProcessNewKeyFrame, LocalMapping.cc:304),
    `mapping_step`, then the loop-candidate probe (`loop_probe`). Updates
    `m`, `bow_db` and `active` in place, reads nothing back to the host.

    Returns (m, bow_db, active, pack (16,)): [probe (3 n_best + 2, all -1
    without a probe) | n_mp | n_kf | zeros]."""
    dev = bow_db.device
    kf_id = _index(kf_id, dev)
    words = _descend(centroids, ms.row(m.kf_desc, kf_id), k, depth)
    v = bow_vector(words, ms.row(m.kf_feat_valid, kf_id), idf, k ** depth)
    ms.set_row(bow_db, kf_id, v)
    ms.set_row(active, kf_id, torch.ones((), dtype=torch.bool, device=dev))
    mapping_step(m, kf_id, cam_params, cam_model=cam_model, img_w=img_w,
                 img_h=img_h, n_levels=n_levels, n_tri=n_tri, n_fuse=n_fuse,
                 do_cull_kf=do_cull_kf, th_far=th_far)
    if with_probe:
        probe = loop_probe(m, bow_db, active, centroids, idf, kf_id, k=k,
                           depth=depth, n_best=n_best, prev_cand=prev_cand)
    else:
        probe = torch.full((3 * n_best + 2,), -1.0, device=dev)
    aux = torch.stack([m.n_mp.to(torch.float32), m.n_kf.to(torch.float32)])
    pack = torch.cat([probe, aux, torch.zeros(16 - probe.shape[0] - 2, device=dev)])
    return m, bow_db, active, pack


def verify_loop_fused(m: ms.MapState, kf_id, cand, cam_params,
                      cam_model: int = 0, img_w: int = 640, img_h: int = 400,
                      n_levels: int = 8, fix_scale: bool = False, hyp_idx=None):
    """The geometric verification cascade with one result pack
    (DetectCommonRegionsFromBoW, LoopClosing.cc:583-800): landmark matching
    -> Sim3 RANSAC -> coarse neighbourhood reprojection -> SearchBySim3 ->
    OptimizeSim3 -> fine reprojection -> the implied rotation correction.
    Every stage runs; the host applies the gate ladder to the pack.
    `hyp_idx` replaces the RANSAC draws (tests).

    Pack (24 f32): [0] n_matches [1] n_inl_ransac [2] n_proj_coarse
    [3] n_inl_opt [4] n_proj_fine [5:14] R12 [14:17] t12 [17] s12
    [18:21] phi (so3 log of the current keyframe's implied correction)
    [21:24] zeros."""
    kf, c = _kf(m, kf_id), _kf(m, cand)
    p_a, p_b, uv_a, uv_b, valid, idx = match_kf_landmarks(m, kf, c)
    n_match = valid.sum().to(torch.float32)
    R12, t12, s12, inl, n_inl = sim3_mod.sim3_ransac(
        p_a, p_b, uv_a, uv_b, valid, cam_params, cam_model=cam_model,
        fix_scale=fix_scale, hyp_idx=hyp_idx)
    ck = dict(cam_model=cam_model, img_w=img_w, img_h=img_h, n_levels=n_levels)
    n_proj = project_count_sim3(m, kf, c, R12, t12, s12, cam_params, radius=8.0, **ck)
    p_a2, p_b2, uv_a2, uv_b2, v2 = search_by_sim3(
        m, kf, c, R12, t12, s12, cam_params, idx, inl & valid, **ck)
    R12o, t12o, s12o, _, n_inlo = sim3_mod.optimize_sim3(
        R12, t12, s12, p_a2, p_b2, uv_a2, uv_b2, v2, cam_params,
        cam_model=cam_model, fix_scale=fix_scale)
    n_proj2 = project_count_sim3(m, kf, c, R12o, t12o, s12o, cam_params,
                                 radius=5.0, **ck)
    Rc_new = R12o @ ms.row(m.kf_R, c)
    phi = lie.so3_log(Rc_new @ ms.row(m.kf_R, kf).T)
    counts = torch.stack([n_match, n_inl.to(torch.float32), n_proj.to(torch.float32),
                          n_inlo.to(torch.float32), n_proj2.to(torch.float32)])
    return torch.cat([counts, R12o.reshape(-1), t12o, s12o.reshape(1), phi,
                      torch.zeros(3, device=phi.device)])


class LoopCloser:
    """Host-side loop-detection state machine that also runs the correction
    and, unless `async_gba`, the global BA inside `on_probe_result`
    (`abort_gba`, polled between its LM chunks, is the mbStopGBA flag)."""

    # staged-verification thresholds (LoopClosing.cc:583-589); the
    # projection counts scale with the feature budget, with floors
    RANSAC_INLIERS = 15          # nBoWInliers
    REF_FEAT_BUDGET = 1250.0
    PROJ_MATCHES = 50            # nProjMatches at REF_FEAT_BUDGET
    PROJ_OPT_MATCHES = 80        # nProjOptMatches at REF_FEAT_BUDGET
    PROJ_FLOOR = 20
    PROJ_OPT_FLOOR = 25
    PROBE_N = 3
    LOOP_EDGE_CAP = 16
    # the candidate's BoW score floor; ORB-SLAM3's NewDetectCommonRegions
    # has no covisible-neighbour floor (the reference's
    # `use_min_score_floor`, off there and not ported), so the probe's
    # min_score is carried in the pack but not used
    SCORE_FLOOR = 0.015

    def __init__(self, cfg, place_rec, min_matches: int = 20,
                 min_inliers: int = 20, consistency_needed: int = 3,
                 gba_iters: int = 10, fix_scale: bool = False):
        self.cfg = cfg
        self.pr = place_rec
        self.min_matches = min_matches
        self.min_inliers = min_inliers
        self.consistency_needed = consistency_needed
        self.consistent_candidate = -1
        self.consistency_count = 0
        self.last_loop_kf = -999
        self.n_loops = 0
        # inertial maps: 4-DoF essential graph and the scale / pitch-roll
        # gates (LoopClosing.cc:144-163)
        self.inertial = False
        # stereo: depth fixes the scale (Sim3Solver with bFixScale)
        self.fix_scale = fix_scale
        # rigid delta of the last correction (device tensors)
        self.last_delta = None
        # persistent loop edges (KeyFrame::mspLoopEdges): (loop kf, cur kf)
        self.loop_edges: list = []
        self.gba_iters = gba_iters
        self.abort_gba = False
        self.async_gba = bool(cfg.mapping.async_gba)
        # the last verification: (kf_id, cand, its 24-float pack)
        self.last_verification = None

    def remap_keyframes(self, kf_new) -> None:
        """Rewrite the stored loop edges after the keyframe slots were
        re-indexed (kf_new: old id -> new id or -1); edges touching a culled
        keyframe are dropped."""
        out = []
        for i, j in self.loop_edges:
            if 0 <= i < len(kf_new) and 0 <= j < len(kf_new):
                ni, nj = int(kf_new[i]), int(kf_new[j])
                if ni >= 0 and nj >= 0:
                    out.append((ni, nj))
        self.loop_edges = out

    def probe_gates_ok(self, kf_id: int, n_kf: int) -> bool:
        return not (n_kf < 8 or kf_id - self.last_loop_kf < 10)

    def dispatch_probe(self, m: ms.MapState, kf_id: int, n_kf: int):
        """The candidate probe, queued and not read (reference :699-715): a
        (16,) device tensor [probe (11) | zeros] for `on_probe_result` once it
        reaches the host, or None when the keyframe fails the probe gates.
        With the native inverted-file database (`native.NativeBowDatabase`)
        the probe runs on the host at once (`_native_probe`)."""
        if not self.probe_gates_ok(kf_id, n_kf):
            return None
        if not hasattr(self.pr, "bow_db"):
            return self._native_probe(m, kf_id)
        voc = self.pr.voc
        out = loop_probe(m, self.pr.bow_db, self.pr.active, voc.centroids, voc.idf,
                         kf_id, k=voc.k, depth=voc.depth, n_best=self.PROBE_N,
                         prev_cand=self.consistent_candidate)
        return torch.cat([out, torch.zeros(16 - out.shape[0], device=out.device)])

    def _native_probe(self, m: ms.MapState, kf_id: int) -> np.ndarray:
        """The probe against the native database (reference `_probe`'s second
        branch, :732-775), on the host: a (3 n_best + 1,) pack [ids | scores
        | covis_w | min_score] with no BoW-match count, so that
        `on_probe_result` skips that gate as the reference does there.
        Excluded: covisible keyframes, the 8 nearest ids, keyframes within
        2 s, culled keyframes. min_score, the worst score of a covisible
        neighbour (weight >= 15), is 0 when there is none; covis_w is each
        candidate's covisibility with the previous consistent candidate."""
        n = self.PROBE_N
        C = ms.covisibility(m).cpu().numpy()
        covis = C[kf_id]
        exclude = covis > 0
        exclude[kf_id] = True
        exclude[max(0, kf_id - 8):kf_id + 9] = True
        ts = m.kf_ts.cpu().numpy()
        exclude |= np.abs(ts - ts[kf_id]) < 2.0
        exclude |= ~m.kf_valid.cpu().numpy()
        desc, valid = m.kf_desc[kf_id], m.kf_feat_valid[kf_id]
        covis_ids = np.flatnonzero(covis >= 15)
        covis_ids = covis_ids[covis_ids != kf_id]
        min_score = float(self.pr.query_scores(desc, valid)[covis_ids].min()) \
            if len(covis_ids) else 0.0
        ids, scores = self.pr.query(desc, valid, exclude_mask=exclude, n_best=n)
        prev = self.consistent_candidate
        cw = C[prev][np.clip(ids, 0, m.max_kf - 1)] if prev >= 0 else np.zeros(n, np.float32)
        return np.concatenate([ids.astype(np.float32), scores, cw.astype(np.float32),
                               [min_score]]).astype(np.float32)

    def on_probe_result(self, m: ms.MapState, kf_id: int, vals,
                        cam_params) -> ms.MapState:
        """Consume a probe pack read to the host (numpy): the consistency
        state machine, and on a consistent candidate the verification and
        the correction."""
        n = self.PROBE_N
        vals = np.asarray(vals)
        return self._after_probe(
            m, kf_id, vals[:n].astype(np.int32), vals[n:2 * n], vals[2 * n:3 * n],
            cam_params, n_bow=float(vals[3 * n + 1]) if len(vals) > 3 * n + 1 else None)

    def _after_probe(self, m: ms.MapState, kf_id: int, ids, scores, covis_w,
                     cam_params, n_bow=None) -> ms.MapState:
        cand = int(ids[0])
        if cand < 0 or float(scores[0]) <= self.SCORE_FLOOR:
            self.consistency_count = 0
            return m
        # temporal consistency (mnLoopNumCoincidences >= 3): the candidate
        # group overlaps the previous one, or its id is within 5
        if self.consistent_candidate >= 0 and \
                (covis_w[0] > 0 or abs(cand - self.consistent_candidate) <= 5):
            self.consistency_count += 1
        else:
            self.consistency_count = 1
        self.consistent_candidate = cand
        if self.consistency_count < self.consistency_needed:
            return m
        # nBoWMatches >= 20 from the probe pack: no further device work
        if n_bow is not None and 0 <= n_bow < self.min_matches:
            return m

        # the cascade (LoopClosing.cc:583-800) as one pack, one read
        fix_scale = self.fix_scale or self.inertial
        cam = self.cfg.camera
        fs = float(m.n_feat) / self.REF_FEAT_BUDGET
        proj_th = max(self.PROJ_FLOOR, round(self.PROJ_MATCHES * fs))
        proj_opt_th = max(self.PROJ_OPT_FLOOR, round(self.PROJ_OPT_MATCHES * fs))
        pack_dev = verify_loop_fused(m, kf_id, cand, cam_params,
                                     cam_model=cam.model_id, img_w=cam.width,
                                     img_h=cam.height, n_levels=self.cfg.orb.n_levels,
                                     fix_scale=fix_scale)
        pack = pack_dev.cpu().numpy()
        self.last_verification = (kf_id, cand, pack)
        n_match, n_inl, n_proj, n_inlo, n_proj2 = (int(x) for x in pack[:5])
        if n_match < self.min_matches or n_inl < self.RANSAC_INLIERS:
            return m
        if n_proj < proj_th:                   # coarse reprojection (th 8)
            self.consistency_count = 0
            return m
        if n_inlo < self.min_inliers:          # OptimizeSim3 inliers
            return m
        if n_proj2 < proj_opt_th:              # fine reprojection (th 5)
            self.consistency_count = 0
            return m
        s12 = float(pack[17])
        phi = pack[18:21]
        if self.inertial:
            # the correction must keep the IMU's scale and be yaw-only:
            # pitch / roll (x, z; yaw is about y) under 0.008 rad
            if not (0.9 < s12 < 1.1) or abs(float(phi[0])) > 0.008 \
                    or abs(float(phi[2])) > 0.008:
                self.consistency_count = 0
                return m

        S12 = (pack_dev[5:14].reshape(3, 3), pack_dev[14:17], pack_dev[17])
        m = self.correct(m, kf_id, cand, S12)
        self.last_loop_kf = kf_id
        self.consistency_count = 0
        self.n_loops += 1
        # full-map BA after the correction (RunGlobalBundleAdjustment,
        # LoopClosing.cc:1206); with async_gba the tracker starts it instead
        if self.gba_iters > 0 and not self.async_gba:
            self.abort_gba = False
            m = global_bundle_adjust(
                m, cam_params, bf=float(self.cfg.bf), cam_model=cam.model_id,
                n_iters=self.gba_iters, chunk=5, n_ba_points=min(m.max_mp, 4096),
                should_abort=lambda: self.abort_gba)
        return m

    def correct(self, m: ms.MapState, kf_cur: int, kf_loop: int, S12) -> ms.MapState:
        """CorrectLoop (LoopClosing.cc:969): the current keyframe's corrected
        pose S12 o T_loop_w seeds an essential-graph optimisation (loop
        keyframe fixed) with every stored loop edge and the new one; then
        the landmarks are re-anchored. S12 maps loop-camera points into the
        current camera: p_cur ~ S12 p_loop."""
        R12, t12, s12 = S12
        K = m.max_kf
        dev = m.kf_R.device
        old_R, old_t = m.kf_R, m.kf_t
        one = torch.ones((), device=dev)
        Rl, tl = m.kf_R[kf_loop], m.kf_t[kf_loop]
        Rc_new, tc_new, sc_new = lie.sim3_compose(R12, t12, s12, Rl, tl, one)

        e_i, e_j, e_valid = essential_edges(m)
        # the stored loop edges in a block of fixed capacity
        cap = self.LOOP_EDGE_CAP
        hist = np.zeros((3, cap), np.int32)
        for n, (i, j) in enumerate(self.loop_edges[-cap:]):
            hist[:, n] = (i, j, 1)
        hist = to_device(hist, dev)
        old_i, old_j = hist[0], hist[1]
        e_valid = torch.cat([e_valid, (hist[2] > 0) & m.kf_valid[old_i.long()]
                             & m.kf_valid[old_j.long()]])
        e_i = torch.cat([e_i, old_i])
        e_j = torch.cat([e_j, old_j])
        # measurements S_j S_i^-1 from the current poses, and the new loop
        # edge (i = loop, j = cur) with the corrected relative pose
        ei, ej = e_i.long(), e_j.long()
        Rm, tm, _ = pose_graph.relative_sim3(m.kf_R[ej], m.kf_t[ej], one,
                                             m.kf_R[ei], m.kf_t[ei], one)
        Rrel, trel, srel = pose_graph.relative_sim3(Rc_new, tc_new, sc_new, Rl, tl, one)
        e_i = torch.cat([e_i, torch.full((1,), kf_loop, dtype=torch.int32, device=dev)])
        e_j = torch.cat([e_j, torch.full((1,), kf_cur, dtype=torch.int32, device=dev)])
        e_valid = torch.cat([e_valid, torch.ones(1, dtype=torch.bool, device=dev)])
        e_R = torch.cat([Rm, Rrel[None]])
        e_t = torch.cat([tm, trel[None]])
        e_s = torch.cat([torch.ones(e_i.shape[0] - 1, device=dev), srel.reshape(1)])
        self.loop_edges.append((int(kf_loop), int(kf_cur)))

        ii = torch.arange(K, device=dev)
        fixed = ii == kf_loop
        cur = (ii == kf_cur)
        kf_R0 = torch.where(cur[:, None, None], Rc_new, m.kf_R)
        kf_t0 = torch.where(cur[:, None], tc_new, m.kf_t)
        kf_s0 = torch.where(cur, sc_new, torch.ones(K, device=dev))
        # inertial maps: 4-DoF (Optimizer.cc:5338); visual: 7-DoF Sim3
        mode = "4dof" if self.inertial else "sim3"
        new_R, new_t, new_s = pose_graph.optimize_pose_graph(
            kf_R0, kf_t0, kf_s0, m.kf_valid, fixed, e_i, e_j, e_R, e_t, e_s,
            e_valid, mode=mode, n_iters=15)
        m = apply_pose_graph_result(m, new_R, new_t, new_s, old_R, old_t,
                                    scale_points=not self.fix_scale)
        oRc, oTc = old_R[kf_cur], old_t[kf_cur]
        self.last_delta = (oRc.T @ m.kf_R[kf_cur], oRc.T @ (m.kf_t[kf_cur] - oTc))
        return m


class MapMerger:
    """Cross-map place recognition, Sim3 verification and the Atlas merge
    (the visual branch of the reference's MapMerger, loop_closing.py:240).

    Each archived map keeps its frozen BoW database (`archive`); every new
    keyframe of the current map queries all of them (`on_keyframe`). The
    best hit of every archive is computed on the device and read in one
    host copy per keyframe (the reference reads each archive's id and score
    apart). A hit scoring over `SCORE_TH`, on the same archive as the
    previous one and within 2 keyframes of its candidate, counts towards
    `consistency_needed`; then >= `MIN_MATCHES` cross matches, >=
    `MIN_INLIERS` Sim3 RANSAC inliers and as many after OptimizeSim3, and a
    scale in (0.5, 2.0) accept the merge, in (0.9, 1.1) with `inertial`
    (LoopClosing.cc:144-163), whose weld is then the world Sim(3)'s yaw
    alone with scale 1: both maps are gravity-aligned, +y down
    (MergeLocal2, LoopClosing.cc:1783). A merge whose old candidate
    keyframe would not fit in the current map's keyframe slots is not made
    (the archive stays). The RANSAC draws come from `mapping/sim3.sim3_ransac`'s
    sampler (tests inject the reference's)."""

    WELD_HALF = 3        # keyframes on each side of the weld seam
    SCORE_TH = 0.015     # the reference's gates (loop_closing.py:240)
    MIN_MATCHES = 20
    MIN_INLIERS = 20

    def __init__(self, cfg, consistency_needed: int = 3):
        self.cfg = cfg
        self.consistency_needed = consistency_needed
        self.archives: list = []      # [{"map_idx": int, "db": PlaceRecognition}]
        self.consistent = (-1, -1)    # (archive position, candidate keyframe)
        self.count = 0
        self.n_merges = 0
        # set by the tracker once its IMU is initialised
        self.inertial = False
        # the last merge: {"kf_cur", "kf_old", "src_idx", "gaps"}, "gaps" the
        # archived map's preintegration registry in merged keyframe ids
        self.last_merge = None

    def archive(self, map_idx: int, db, gaps=None) -> None:
        """Freeze the BoW database of a map being archived (a new map is
        spawned), and its preintegration registry {dst kf: (src kf, pre)}
        (the inertial edges that a later MergeInertialBA welds with);
        nothing writes into either afterwards."""
        if db is not None:
            self.archives.append({"map_idx": map_idx, "db": db,
                                  "gaps": dict(gaps) if gaps else {}})

    def best_hits(self, m: ms.MapState, kf_id: int) -> np.ndarray:
        """(n_archives, 2) host array of every archive's best keyframe id and
        its score for keyframe `kf_id` of `m`: one query vector, one read."""
        dev = m.kf_R.device
        k = torch.full((), kf_id, dtype=torch.int64, device=dev)
        voc = self.archives[0]["db"].voc
        q = bow_from_descriptors(voc, ms.row(m.kf_desc, k), ms.row(m.kf_feat_valid, k))
        hits = []
        for arc in self.archives:
            db = arc["db"]
            s = l1_scores(db.bow_db, q)
            s = torch.where(db.active, s, torch.full_like(s, -1.0))
            top_s, top_i = topk_stable(s, 1)
            hits.append(torch.cat([top_i.to(torch.float32), top_s]))
        return torch.stack(hits).cpu().numpy()

    def on_keyframe(self, atlas, kf_id: int, cam_params) -> bool:
        """Query the archived maps with the current map's keyframe `kf_id`;
        on a verified hit, merge that map into the current one and run the
        welding BA. Returns True after a merge (the caller rebuilds its live
        BoW database)."""
        if not self.archives:
            return False
        m = atlas.current_map
        best = (-1, -1, 0.0)  # (archive position, candidate keyframe, score)
        for pos, (cand, score) in enumerate(self.best_hits(m, kf_id)):
            if cand >= 0 and score > best[2]:
                best = (pos, int(cand), float(score))
        pos, cand, score = best
        if pos < 0 or score <= self.SCORE_TH:
            self.count = 0
            return False
        # temporal consistency: consecutive hits on one archive, nearby keyframes
        if self.consistent[0] == pos and abs(cand - self.consistent[1]) <= 2:
            self.count += 1
        else:
            self.count = 1
        self.consistent = (pos, cand)
        if self.count < self.consistency_needed:
            return False

        arc = self.archives[pos]
        old = atlas.maps[arc["map_idx"]]
        p_a, p_b, uv_a, uv_b, valid = match_kf_landmarks_cross(m, kf_id, old, cand)
        if int(valid.sum()) < self.MIN_MATCHES:
            return False
        R12, t12, s12, inl, n_inl = sim3_mod.sim3_ransac(
            p_a, p_b, uv_a, uv_b, valid, cam_params)
        if int(n_inl) < self.MIN_INLIERS:
            return False
        R12, t12, s12, inl, n_inl = sim3_mod.optimize_sim3(
            R12, t12, s12, p_a, p_b, uv_a, uv_b, inl & valid, cam_params)
        if int(n_inl) < self.MIN_INLIERS:
            return False
        s_lo, s_hi = (0.9, 1.1) if self.inertial else (0.5, 2.0)
        if not s_lo < float(s12) < s_hi:
            return False

        Rw, tw, sw = merge_world_sim3(m.kf_R[kf_id], m.kf_t[kf_id], R12, t12, s12,
                                      old.kf_R[cand], old.kf_t[cand])
        if self.inertial:
            # the yaw about the gravity axis (+y) alone, scale 1
            Rn = Rw.cpu().numpy().astype(np.float64)
            yaw = np.arctan2(Rn[0, 2] - Rn[2, 0], Rn[0, 0] + Rn[2, 2])
            cy, sy = np.cos(yaw), np.sin(yaw)
            Rw = to_device(np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32),
                           Rw.device)
            sw = torch.ones((), dtype=torch.float32, device=Rw.device)
        src_idx = arc["map_idx"]
        n_dst_before = int(m.n_kf)
        # where the candidate lands after merge_into's compacting append
        kf_valid_old = old.kf_valid.cpu().numpy()
        rank = np.cumsum(kf_valid_old) - 1
        cand_new = n_dst_before + int(rank[cand])
        if cand_new >= m.max_kf:
            # merge_into would drop the candidate: the weld would lose its
            # anchor on the archived side
            return False
        atlas.merge(src_idx, Rw, tw, sw)
        self._welding_ba(atlas, kf_id, cand_new, cam_params)
        # the archived registry in merged ids (gaps between valid keyframes)
        gaps = {}
        for dst, (src, pre) in arc["gaps"].items():
            if 0 <= dst < len(kf_valid_old) and kf_valid_old[dst] \
                    and 0 <= src < len(kf_valid_old) and kf_valid_old[src]:
                gaps[n_dst_before + int(rank[dst])] = (n_dst_before + int(rank[src]), pre)
        self.last_merge = {"kf_cur": kf_id, "kf_old": cand_new, "src_idx": src_idx,
                           "gaps": gaps}
        # the archive is merged; later archives' map indices shift down
        self.archives.pop(pos)
        for a in self.archives:
            if a["map_idx"] > src_idx:
                a["map_idx"] -= 1
        self.count = 0
        self.consistent = (-1, -1)
        self.n_merges += 1
        return True

    def _welding_ba(self, atlas, kf_cur: int, kf_old: int, cam_params) -> None:
        """BA over the weld (MergeLocal's local BA, Optimizer.cc:3532): the
        current keyframe's 3 predecessors and the old candidate with 3 on
        each side, the current keyframe and the old candidate held fixed
        (both carry the verified alignment).

        The reference holds only the current keyframe fixed
        (loop_closing.py:390). With no seam fusion the two sides share no
        landmark, so its archived side has no anchor: a free rigid motion
        that f32 rounding drives, moving those keyframes and their
        landmarks against the rest of the archived map (on the CPU, in
        tests/test_torch_multimap_slam.py's run, the two packages' 4
        archived keyframes of the weld ended 8.3 mm apart, the same up to
        one rigid motion to 0.4 um). ORB-SLAM3's MergeLocal holds the merged map's side
        fixed; the port anchors it at the old candidate."""
        m = atlas.current_map
        n_kf = int(m.n_kf)
        assert kf_cur < n_kf and kf_old < n_kf
        w = self.WELD_HALF
        sel = sorted(set(range(max(0, kf_cur - w), min(kf_cur + 1, n_kf)))
                     | set(range(max(0, kf_old - w), min(kf_old + w + 1, n_kf))))
        if len(sel) < 3:
            return
        C = 2 * (2 * w + 1)
        ids = np.full(C, -1, np.int32)
        fixed = np.zeros(C, bool)
        ids[:len(sel)] = sel
        fixed[:len(sel)] = [k in (kf_cur, kf_old) for k in sel]
        cfg = self.cfg
        dev = m.kf_R.device
        atlas.current_map = map_window_ba(
            m, to_device(ids, dev), to_device(fixed, dev), cam_params, float(cfg.bf),
            cam_model=cfg.camera.model_id, n_ba_points=min(cfg.ba.max_points, m.max_mp),
            n_iters=cfg.ba.n_iters)
