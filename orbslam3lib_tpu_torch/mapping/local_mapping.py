"""Local mapping: new-landmark triangulation, landmark and keyframe
culling, duplicate fusion (port of `orbslam3lib_tpu/mapping/local_mapping.py`).

The reference's LocalMapping thread body (LocalMapping.cc: MapPointCulling
:352, CreateNewMapPoints :394, SearchInNeighbors :726, KeyFrameCulling :914)
as fixed-shape masked tensor math over the MapState arrays. The functions
update the map in place and return it, as `models/map_state` does; none of
them reads a value back to the host, so a keyframe's whole chain
(`mapping_step`) queues on the card without waiting.

Where the reference scatters with duplicate indices, XLA on the CPU keeps
the last write; the port picks that same write explicitly (the highest
source index, `scatter_reduce` "amax"), so the result does not depend on
the order in which the card applies a scatter.
"""
from __future__ import annotations

import torch

from ..models import map_state as ms
from ..ops.fast import topk_stable
from ..ops.masks import is_finite_match, leq_int, penalize, step01
from ..ops.matcher import hamming_matrix, knn2
from ..ops.pyramid import scale_factors_on
from ..tracking.matching import rotation_consistency, search_by_projection
from ..utils import cameras, lie


def _index(x, dev) -> torch.Tensor:
    """A keyframe id as a 0-d int32 tensor on `dev` (filled there: a copy
    from the host would wait for the card's queue)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.full((), x, dtype=torch.int32, device=dev)


def _last_write(tgt: torch.Tensor, n: int) -> torch.Tensor:
    """For a scatter of len(tgt) sources into n slots (targets >= n are
    dropped): the source index that XLA on the CPU leaves in each slot, the
    last (highest) one, or -1 where none writes. (n,) int64."""
    src = torch.arange(tgt.shape[0], device=tgt.device)
    out = torch.full((n + 1,), -1, dtype=torch.int64, device=tgt.device)
    return out.scatter_reduce(0, torch.clamp(tgt.long(), max=n), src,
                              reduce="amax")[:n]


def top_covisible(m: ms.MapState, kf_id, n: int = 10) -> torch.Tensor:
    """Top-n covisible keyframes of kf_id by shared-observation count
    (KeyFrame::GetBestCovisibilityKeyFrames); equal counts keep the lower id
    first, as `lax.top_k`. (n,) int32, -1 where no covisible keyframe."""
    kf_id = _index(kf_id, m.kf_R.device)
    O = ms.observation_matrix(m)                               # (K, P)
    row = O @ ms.row(O, torch.clamp(kf_id, 0, m.max_kf - 1).long())
    row = torch.where(torch.arange(m.max_kf, device=row.device) == kf_id,
                      torch.zeros_like(row), row)
    row = row * m.kf_valid
    top_w, top_i = topk_stable(row, n)
    return torch.where(top_w > 0, top_i, -1).to(torch.int32)


def covis_ba_window(m: ms.MapState, kf_id, n_win: int, n_fixed: int):
    """Local-BA window by covisibility: kf_id and its best covisible
    neighbours, oldest first, the oldest n_fixed fixed (the gauge).
    Returns (ids (C,) int32 -1-padded at the end, fixed (C,) bool)."""
    C = n_fixed + n_win
    kf_id = _index(kf_id, m.kf_R.device)
    nbrs = top_covisible(m, kf_id, C - 1)
    big = 10 ** 9
    sel = torch.cat([torch.where(nbrs >= 0, nbrs, big), kf_id.reshape(1)])
    sel = torch.sort(sel).values
    ids = torch.where(sel < big, sel, -1)
    fixed = torch.arange(C, device=ids.device) < n_fixed
    return ids, fixed


def observed_mp_mask(m: ms.MapState, kf_ids: torch.Tensor) -> torch.Tensor:
    """(P,) bool: valid landmarks observed by any of kf_ids (-1 ignored)."""
    ids = torch.clamp(kf_ids, 0, m.max_kf - 1).long()
    rows = m.kf_mp[ids]                                        # (A, F)
    ok = (kf_ids[:, None] >= 0) & (rows >= 0) & m.kf_feat_valid[ids]
    tgt = torch.where(ok, rows, m.max_mp).long().reshape(-1)
    # index_fill_, not `mask[tgt] = True`: a Python value stored through an
    # index tensor is first copied from the host, which waits for the card
    mask = torch.zeros(m.max_mp + 1, dtype=torch.bool, device=rows.device)
    mask.index_fill_(0, tgt, True)
    return mask[:m.max_mp] & m.mp_valid


def _tri_pair_candidates(m: ms.MapState, kf_a, kf_b, cam_params, cam_model: int,
                         n_levels: int, nn_ratio: float, th_desc: float,
                         epi_sigma: float, th_far=None):
    """Candidate stage of triangulation between keyframe kf_a and each of
    the neighbours kf_b (Nn,): match, triangulate, gate; the map is not
    changed. The reference vmaps its single pair over the neighbours; here
    the neighbour is an explicit leading dim. Returns (want, p_w, best,
    cosp, normal, min_dist, max_dist), each with leading dims (Nn, F)."""
    dev = m.kf_R.device
    Nn = kf_b.shape[0]
    kf_a = _index(kf_a, dev)
    a = torch.clamp(kf_a, 0, m.max_kf - 1).long()
    b = torch.clamp(kf_b, 0, m.max_kf - 1).long()
    Ra, ta = ms.row(m.kf_R, a), ms.row(m.kf_t, a)
    Rb, tb = m.kf_R[b], m.kf_t[b]
    xy_a, xy_b = ms.row(m.kf_xy, a), m.kf_xy[b]
    lvl_a, lvl_b = ms.row(m.kf_level, a), m.kf_level[b]
    free_a = ms.row(m.kf_feat_valid, a) & (ms.row(m.kf_mp, a) < 0)
    free_b = m.kf_feat_valid[b] & (m.kf_mp[b] < 0)
    iN = torch.arange(Nn, device=dev)[:, None]

    # relative pose cam_a <- cam_b and the essential matrix x_a^T E x_b = 0
    Rab = Ra @ Rb.transpose(-1, -2)                            # (Nn, 3, 3)
    tab = ta - (Rab @ tb[..., None])[..., 0]                   # (Nn, 3)
    E = lie.hat(tab) @ Rab
    ray_a = cameras.unproject(cam_model, cam_params, xy_a)     # (F, 3)
    ray_b = cameras.unproject(cam_model, cam_params, xy_b)     # (Nn, F, 3)

    # epipolar distance of ray_b to the line E^T ray_a, in pixels
    l_b = ray_a @ E                                            # (Nn, F, 3)
    num = torch.abs(l_b @ ray_b.transpose(-1, -2))             # (Nn, F, F)
    den = torch.sqrt(l_b[..., 0:1] ** 2 + l_b[..., 1:2] ** 2 + 1e-12)
    epi_px = (num / den) * cam_params[0]
    sf = scale_factors_on(n_levels, dev)
    sig_a = sf[torch.clamp(lvl_a, 0, n_levels - 1).long()]      # (F,)
    sig_b = sf[torch.clamp(lvl_b, 0, n_levels - 1).long()]      # (Nn, F)
    g_epi = step01(3.84 * epi_sigma * sig_b[:, None, :] - epi_px + 0.5)

    d = hamming_matrix(ms.row(m.kf_desc, a), m.kf_desc[b])       # (Nn, F, F)
    g = g_epi * leq_int(d, th_desc)
    g = g * free_a.to(torch.float32)[None, :, None] * free_b.to(torch.float32)[:, None, :]
    best, d1, d2 = knn2(penalize(d, g))                        # kNN-2 along b
    best = best.long()
    has = is_finite_match(d1) * step01((nn_ratio * d2 - d1) + 0.5)

    # triangulate the matches in cam_a's frame
    rb_sel = ray_b[iN, best]
    F = best.shape[1]
    p_a, cosp, z1, z2 = cameras.triangulate_two_view(
        ray_a.expand(Nn, F, 3), rb_sel, Rab[:, None].expand(Nn, F, 3, 3),
        tab[:, None].expand(Nn, F, 3))
    # reprojection gates in both views
    uv_a = cameras.project(cam_model, cam_params, p_a)
    p_b = torch.einsum("nji,nfj->nfi", Rab, p_a - tab[:, None])
    uv_b = cameras.project(cam_model, cam_params, p_b)
    err_a = torch.sum((uv_a - xy_a) ** 2, dim=-1)
    err_b = torch.sum((uv_b - xy_b[iN, best]) ** 2, dim=-1)
    sig_b_best = sig_b[iN, best]
    ok = has
    ok = ok * step01((0.9998 - cosp) * 1e5)                    # parallax gate
    ok = ok * step01((z1 - 0.05) * 20.0) * step01((z2 - 0.05) * 20.0)
    ok = ok * step01(5.991 * sig_a ** 2 - err_a + 0.5)
    ok = ok * step01(5.991 * (sig_a[best] ** 2) - err_b + 0.5)
    ok = ok * step01(torch.linalg.norm(tab, dim=-1) * 1e3)[:, None]   # baseline
    # scale consistency (LocalMapping.cc: ratioDist vs ratioOctave * 1.5)
    Rwa, ca = lie.se3_inverse(Ra, ta)
    p_w = lie.se3_apply(Rwa, ca, p_a)
    _, cb = lie.se3_inverse(Rb, tb)
    dist_a = torch.linalg.norm(p_w - ca, dim=-1)
    dist_b = torch.linalg.norm(p_w - cb[:, None], dim=-1)
    ratio_d = dist_a / torch.clamp(dist_b, min=1e-6)
    ratio_o = sig_a / torch.clamp(sig_b_best, min=1e-6)
    ok = ok * step01((ratio_d - ratio_o / 1.5) * 8.0)
    ok = ok * step01((ratio_o * 1.5 - ratio_d) * 8.0)
    if th_far is not None and th_far > 0:
        # thFarPoints (LocalMapping.cc:696): both view distances under it
        ok = ok * step01((th_far - dist_a) * 8.0) * step01((th_far - dist_b) * 8.0)
    # neighbour validity (-1 pads, self-pairs, culled neighbours), exact gates
    ok = ok * (step01(kf_b.to(torch.float32) + 1.0)
               * step01(torch.abs(kf_a - kf_b).to(torch.float32))
               * m.kf_valid[b].to(torch.float32))[:, None]

    # rotation-consistency histogram (SearchForTriangulation's CheckOrientation)
    ang_a = ms.row(m.kf_angle, a)
    want = rotation_consistency(ang_a.expand(Nn, F), m.kf_angle[b][iN, best], ok > 0.5)
    normal = (p_w - ca) / torch.clamp(dist_a[..., None], min=1e-9)
    max_dist = dist_a * sig_a
    min_dist = max_dist / sf[n_levels - 1]
    return want, p_w, best, cosp, normal, min_dist, max_dist


def _bind_second_view(kf_mp: torch.Tensor, kf_b, bind: torch.Tensor,
                      best: torch.Tensor, new_ids: torch.Tensor) -> None:
    """Bind the triangulated landmarks new_ids (F,) of the `bind`-masked
    features to their matches `best` in keyframe kf_b (0-d), in place.
    Several features may match one feature of kf_b (no cross-check): the
    highest feature index wins, the write XLA on the CPU keeps."""
    F = best.shape[0]
    b = torch.clamp(kf_b, 0, kf_mp.shape[0] - 1).long()
    row_b = ms.row(kf_mp, b)
    src = _last_write(torch.where(bind, best, F), F)           # (F,) over kf_b slots
    row_b2 = torch.where(src >= 0, new_ids[torch.clamp(src, min=0)], -1)
    ms.set_row(kf_mp, b, torch.where(row_b2 >= 0, row_b2, row_b))


def triangulate_pair(m: ms.MapState, kf_a, kf_b, cam_params,
                     cam_model: int = cameras.PINHOLE, n_levels: int = 8,
                     nn_ratio: float = 0.6, th_desc: float = 50.0,
                     epi_sigma: float = 1.0, th_far=None):
    """CreateNewMapPoints against one neighbour (LocalMapping.cc:394 +
    ORBmatcher::SearchForTriangulation): spawn the landmarks bound to kf_a's
    feature slots and bind the second view in kf_b. Returns (m, n_spawned)."""
    dev = m.kf_R.device
    kf_a = _index(kf_a, dev)
    kf_b = _index(kf_b, dev).reshape(1)
    a = torch.clamp(kf_a, 0, m.max_kf - 1).long()
    want, p_w, best, _, normal, min_dist, max_dist = (
        x[0] for x in _tri_pair_candidates(m, kf_a, kf_b, cam_params, cam_model,
                                           n_levels, nn_ratio, th_desc,
                                           epi_sigma, th_far))
    F = m.n_feat
    ms.spawn_mappoints(m, a, p_w, ms.row(m.kf_desc, a), normal, min_dist,
                       max_dist, want, torch.arange(F, device=dev))
    row_b = ms.row(m.kf_mp, torch.clamp(kf_b[0], 0, m.max_kf - 1).long())
    bind_b = want & (row_b[best] < 0)
    _bind_second_view(m.kf_mp, kf_b[0], bind_b, best, ms.row(m.kf_mp, a))
    return m, want.sum(dtype=torch.int32)


def triangulate_with_neighbors(m: ms.MapState, kf_a, nbrs: torch.Tensor,
                               cam_params, cam_model: int = cameras.PINHOLE,
                               n_levels: int = 8, n_nbrs: int = 10,
                               nn_ratio: float = 0.6, th_desc: float = 50.0,
                               epi_sigma: float = 1.0, th_far=None):
    """CreateNewMapPoints against all covisible neighbours at once: the
    candidate stage over the neighbour dim, one spawn, and a feature slot
    triangulated by several neighbours keeps the best-conditioned pair (the
    smallest cos-parallax, the first neighbour on ties). Returns (m,
    n_spawned)."""
    dev = m.kf_R.device
    F = m.n_feat
    kf_a = _index(kf_a, dev)
    a = torch.clamp(kf_a, 0, m.max_kf - 1).long()
    want, p_w, best, cosp, normal, min_dist, max_dist = _tri_pair_candidates(
        m, kf_a, nbrs, cam_params, cam_model, n_levels, nn_ratio, th_desc,
        epi_sigma, th_far)
    score = torch.where(want, cosp, torch.full_like(cosp, 2.0))  # (Nn, F)
    sel = torch.argmin(score, dim=0)                           # (F,)
    any_want = want.any(dim=0)
    iF = torch.arange(F, device=dev)
    ms.spawn_mappoints(m, a, p_w[sel, iF], ms.row(m.kf_desc, a), normal[sel, iF],
                       min_dist[sel, iF], max_dist[sel, iF], any_want, iF)
    # bind the second-view observation in the winning neighbour, one
    # neighbour after the other as the reference does
    new_ids = ms.row(m.kf_mp, a)
    for i in range(n_nbrs):
        b = torch.clamp(nbrs[i], 0, m.max_kf - 1).long()
        row_b = ms.row(m.kf_mp, b)
        bind_b = any_want & (sel == i) & (row_b[best[i]] < 0) & (nbrs[i] >= 0)
        _bind_second_view(m.kf_mp, nbrs[i], bind_b, best[i], new_ids)
    return m, any_want.sum(dtype=torch.int32)


def cull_mappoints(m: ms.MapState, cur_kf_id) -> ms.MapState:
    """MapPointCulling (LocalMapping.cc:352), in place: drop landmarks with
    found/visible < 0.25 while young, or with <= 2 observations when 2-3
    keyframes old; references to dropped landmarks are scrubbed."""
    n_obs = ms.mp_observation_count(m)
    age = cur_kf_id - m.mp_first_kf                            # in keyframes
    ratio = m.mp_found / torch.clamp(m.mp_visible, min=1.0)
    bad = (ratio < 0.25) & (age <= 3)
    bad = bad | ((age >= 2) & (age <= 3) & (n_obs <= 2))
    new_valid = m.mp_valid & ~bad
    keep = new_valid[torch.clamp(m.kf_mp, 0, m.max_mp - 1).long()] & (m.kf_mp >= 0)
    m.kf_mp = torch.where(keep, m.kf_mp, -1)
    m.mp_valid = new_valid
    m.n_mp = new_valid.sum(dtype=torch.int32)
    return m


def fuse_into_keyframe(m: ms.MapState, kf_id, mp_candidates_valid, cam_params,
                       cam_model: int = cameras.PINHOLE, img_w: int = 640,
                       img_h: int = 400, n_levels: int = 8,
                       radius: float = 3.0, th_desc: float = 50.0):
    """ORBmatcher::Fuse (ORBmatcher.cc:1155) into one keyframe, in place:
    project the candidate landmarks and match them to the keyframe's
    features; an empty slot gains the observation, an occupied one triggers
    MapPoint::Replace keeping the landmark with more observations (the
    loser's references are rewritten through a replace table). Returns (m,
    number of added + replaced)."""
    dev = m.kf_R.device
    P, F = m.max_mp, m.n_feat
    kf_id = _index(kf_id, dev)
    k = torch.clamp(kf_id, 0, m.max_kf - 1).long()
    cand = m.mp_valid & mp_candidates_valid & (kf_id >= 0) & ms.row(m.kf_valid, k)
    pm = search_by_projection(
        m.mp_pos, m.mp_desc, cand, m.mp_normal, m.mp_min_dist, m.mp_max_dist,
        ms.row(m.kf_R, k), ms.row(m.kf_t, k), cam_params, ms.row(m.kf_xy, k),
        ms.row(m.kf_level, k), ms.row(m.kf_desc, k), ms.row(m.kf_feat_valid, k),
        radius, cam_model=cam_model, img_w=img_w, img_h=img_h,
        th_desc=th_desc, n_levels=n_levels)

    n_obs = ms.mp_observation_count(m)
    row = ms.row(m.kf_mp, k)
    pidx = torch.arange(P, device=dev)
    matched = pm.mp_feat >= 0
    f_idx = torch.clamp(pm.mp_feat, 0, F - 1).long()
    occupant = row[f_idx]                                      # landmark or -1

    # an empty slot gains the observation (matches are one-to-one per slot)
    add = matched & (occupant < 0)
    row2 = torch.cat([row, row[:1]])
    row2[torch.where(add, f_idx, F)] = pidx.to(row.dtype)
    row2 = row2[:F]

    # a slot held by another landmark: the one with more observations wins
    clash = matched & (occupant >= 0) & (occupant != pidx)
    occ_c = torch.clamp(occupant, 0, P - 1).long()
    self_better = n_obs >= n_obs[occ_c]
    repl = torch.where(clash & ~self_better, occ_c, pidx)     # dead -> winner
    # several landmarks may beat one occupant: the highest id wins, the
    # write XLA on the CPU keeps
    winner = _last_write(torch.where(clash & self_better, occ_c, P), P)
    repl = torch.where(winner >= 0, winner, repl)
    dead = repl != pidx

    ms.set_row(m.kf_mp, k, row2)
    m.kf_mp = torch.where(m.kf_mp >= 0,
                          repl[torch.clamp(m.kf_mp, 0, P - 1).long()].to(m.kf_mp.dtype),
                          -1)
    m.mp_valid = m.mp_valid & ~dead
    m.n_mp = m.mp_valid.sum(dtype=torch.int32)
    return m, add.sum() + clash.sum()


def mapping_step(m: ms.MapState, kid, cam_params,
                 cam_model: int = cameras.PINHOLE, img_w: int = 640,
                 img_h: int = 400, n_levels: int = 8, n_tri: int = 10,
                 n_fuse: int = 3, do_cull_kf: bool = True, th_far=None):
    """The per-keyframe LocalMapping chain in LocalMapping::Run's order
    (LocalMapping.cc:64): MapPointCulling -> CreateNewMapPoints (all
    neighbours at once) -> SearchInNeighbors, fusing both ways ->
    KeyFrameCulling. In place; returns the map."""
    kid = _index(kid, m.kf_R.device)
    cull_mappoints(m, kid)
    nbrs = top_covisible(m, kid, n_tri)
    triangulate_with_neighbors(m, kid, nbrs, cam_params, cam_model=cam_model,
                               n_levels=n_levels, n_nbrs=n_tri, th_far=th_far)
    # fuse candidates: neighbour-observed landmarks plus recent spawns
    nbr_self = torch.cat([nbrs, kid.reshape(1)])
    fuse_cand = observed_mp_mask(m, nbr_self) | (m.mp_first_kf >= kid - 8)
    kw = dict(cam_model=cam_model, img_w=img_w, img_h=img_h, n_levels=n_levels)
    fuse_into_keyframe(m, kid, fuse_cand, cam_params, **kw)
    own = observed_mp_mask(m, kid.reshape(1))
    for i in range(n_fuse):
        fuse_into_keyframe(m, nbrs[i], own, cam_params, **kw)
    if do_cull_kf:
        protect = torch.stack([torch.zeros_like(kid), torch.clamp(kid - 1, min=0), kid])
        cull_keyframes(m, protect)
    return m


def cull_keyframes(m: ms.MapState, protect_ids: torch.Tensor) -> ms.MapState:
    """KeyFrameCulling (LocalMapping.cc:914), in place: a keyframe is
    redundant when >= 90% of its landmarks are seen by >= 3 other keyframes.
    protect_ids are never culled. At most one keyframe goes per call (the
    first redundant one), and its children take its parent."""
    n_obs = ms.mp_observation_count(m)
    mp_redundant = n_obs >= 4                                  # >= 3 others + self
    has_mp = (m.kf_mp >= 0) & m.kf_feat_valid
    red = has_mp & mp_redundant[torch.clamp(m.kf_mp, 0, m.max_mp - 1).long()]
    n_has = has_mp.sum(dim=1)
    n_red = red.sum(dim=1)
    redundant_kf = m.kf_valid & (n_has > 10) & (n_red >= 0.9 * n_has)
    prot = torch.zeros(m.max_kf, dtype=torch.bool, device=n_has.device)
    prot.index_fill_(0, torch.clamp(protect_ids, 0, m.max_kf - 1).long(), True)
    kill = redundant_kf & ~prot
    # a device-side choice, not a host branch: with no redundant keyframe
    # `do` is False and both writes keep the old values
    first_kill = torch.argmax(kill.to(torch.int32))
    do = kill.any()
    ii = torch.arange(m.max_kf, device=n_has.device)
    m.kf_valid = m.kf_valid & ~(do & (ii == first_kill))
    m.kf_parent = torch.where(do & (m.kf_parent == first_kill),
                              ms.row(m.kf_parent, first_kill), m.kf_parent)
    return m
