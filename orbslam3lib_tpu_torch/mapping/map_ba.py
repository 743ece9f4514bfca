"""Map-level bundle adjustment: the keyframe-window gather and scatter
around `local_ba.bundle_adjust` (port of
`orbslam3lib_tpu/mapping/map_ba.py`), the chunked global BA, its
landmark-sharded form (`global_bundle_adjust_dist`, over
`parallel/dist_ba.py`), the route between them
(`global_bundle_adjust_auto`) and the merge of an asynchronous global BA
into a map that moved on (`merge_gba_result`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import map_state as ms
from ..ops.fast import topk_stable
from ..ops.pyramid import scale_factors_on
from ..utils import lie
from .local_ba import BAProblem, bundle_adjust


def inv_sigma2(level: torch.Tensor, n_levels: int = 8) -> torch.Tensor:
    """Per-observation information 1/scale^2 (the reference's
    mvInvLevelSigma2, Frame.cc)."""
    sf = scale_factors_on(n_levels, level.device)
    s = sf[torch.clamp(level, 0, n_levels - 1).long()]
    return 1.0 / (s * s)


def _gather_window_problem(m: ms.MapState, window_ids, fixed_mask, bf: float,
                           n_ba_points: int):
    """The fixed-shape BA problem over a keyframe window. Returns (prob, ids,
    sel_ids, cam_ok, pt_ok); the last four drive the scatter."""
    C = window_ids.shape[0]
    F = m.n_feat
    P = m.max_mp
    dev = window_ids.device
    ids = torch.clamp(window_ids, 0, m.max_kf - 1).long()
    cam_ok = (window_ids >= 0) & m.kf_valid[ids]

    kf_mp_w = torch.where(cam_ok[:, None] & m.kf_feat_valid[ids], m.kf_mp[ids], -1)
    flat = kf_mp_w.reshape(-1)
    # flag the observed landmarks and keep up to n_ba_points of them, the
    # lowest ids first (lax.top_k's order among equal flags)
    flag = torch.zeros(P, device=dev).scatter_reduce(
        0, torch.clamp(flat, 0, P - 1).long(), (flat >= 0).to(torch.float32),
        reduce="amax")
    flag = flag * m.mp_valid.to(torch.float32)
    sel_flag, sel_ids = topk_stable(flag, n_ba_points)
    pt_ok = sel_flag > 0
    inv = torch.full((P,), -1, dtype=torch.int64, device=dev)
    inv[sel_ids] = torch.arange(n_ba_points, device=dev)

    e_pt = inv[torch.clamp(flat, 0, P - 1).long()]
    e_valid = (flat >= 0) & (e_pt >= 0)
    e_cam = torch.arange(C, device=dev).repeat_interleave(F)
    e_uv = m.kf_xy[ids].reshape(-1, 2)
    e_level = m.kf_level[ids].reshape(-1)
    e_depth = m.kf_depth[ids].reshape(-1)
    e_stereo = e_depth > 0.05
    z_safe = torch.clamp(e_depth, min=0.05)
    e_u_right = torch.where(e_stereo, e_uv[:, 0] - bf / z_safe, torch.zeros_like(z_safe))

    prob = BAProblem(
        cam_R=m.kf_R[ids], cam_t=m.kf_t[ids],
        cam_fixed=fixed_mask | ~cam_ok, cam_valid=cam_ok,
        points=m.mp_pos[sel_ids], pt_valid=pt_ok,
        e_cam=e_cam, e_pt=torch.where(e_valid, e_pt, 0),
        # 8 levels as the reference writes it (map_ba.py:76), whatever the
        # configured pyramid depth
        e_uv=e_uv, e_inv_sigma2=inv_sigma2(e_level, 8),
        e_u_right=e_u_right, e_stereo=e_stereo, e_valid=e_valid,
    )
    return prob, ids, sel_ids, cam_ok, pt_ok


def _scatter_window_result(m: ms.MapState, cam_R, cam_t, points, ids, sel_ids,
                           cam_ok, pt_ok, fixed_mask) -> ms.MapState:
    """Write the optimised cameras (valid, non-fixed) and points back, in
    place. Only updated cameras are written: empty window slots alias
    keyframe 0, so writing every slot would race on it."""
    K = m.max_kf
    tgt = torch.where(cam_ok & ~fixed_mask, ids, K)
    for name, val in (("kf_R", cam_R), ("kf_t", cam_t)):
        arr = getattr(m, name)
        buf = torch.cat([arr, arr[:1]])
        buf[tgt] = val
        arr.copy_(buf[:K])
    m.mp_pos[sel_ids] = torch.where(pt_ok[:, None], points, m.mp_pos[sel_ids])
    return m


def map_window_ba(m: ms.MapState, window_ids, fixed_mask, cam_params, bf: float,
                  cam_model: int, n_ba_points: int, n_iters: int) -> ms.MapState:
    """Gather a BA problem over a keyframe window, solve, and scatter the
    result back into `m` (in place). window_ids (C,) int (-1 = empty slot),
    fixed_mask (C,) bool. Reference: LocalBundleAdjustment (Optimizer.cc:1124),
    window keyframes optimisable, anchors fixed, all their landmarks free."""
    prob, ids, sel_ids, cam_ok, pt_ok = _gather_window_problem(
        m, window_ids, fixed_mask, bf, n_ba_points)
    cam_R, cam_t, points, _ = bundle_adjust(prob, cam_params, cam_model=cam_model,
                                            bf=bf, n_iters=n_iters)
    return _scatter_window_result(m, cam_R, cam_t, points, ids, sel_ids,
                                  cam_ok, pt_ok, fixed_mask)


def global_bundle_adjust(m: ms.MapState, cam_params, bf: float,
                         cam_model: int = 0, n_iters: int = 10, chunk: int = 5,
                         n_ba_points: Optional[int] = None,
                         should_abort: Optional[Callable[[], bool]] = None
                         ) -> ms.MapState:
    """Full-map BA (GlobalBundleAdjustemnt, Optimizer.cc:53): `map_window_ba`
    over all max_kf slots (empty ones fixed and unwritten), the first valid
    keyframe fixed as the gauge, in LM chunks of `chunk` iterations with
    `should_abort` polled between them (the mbStopGBA flag of
    RunGlobalBundleAdjustment, LoopClosing.cc:2268). In place.

    This is the reference's single-device route of
    `global_bundle_adjust_auto`."""
    K = m.max_kf
    ii = torch.arange(K, dtype=torch.int32, device=m.kf_R.device)
    window_ids = torch.where(m.kf_valid, ii, -1)
    fixed = ii == torch.argmax(m.kf_valid.to(torch.int32))
    if n_ba_points is None:
        n_ba_points = m.max_mp
    done = 0
    while done < n_iters:
        it = min(chunk, n_iters - done)
        m = map_window_ba(m, window_ids, fixed, cam_params, bf, cam_model,
                          n_ba_points, it)
        done += it
        if should_abort is not None and should_abort():
            break
    return m


def gba_mesh(device: torch.device):
    """The mesh `global_bundle_adjust_auto` shards over: every visible card,
    the map's first, when the map is on a card and the process sees more
    than one (the reference's mesh over `jax.devices()`); else None."""
    from ..parallel.dist_ba import DeviceMesh
    device = torch.device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if n <= 1:
        return None
    first = device.index or 0
    return DeviceMesh([f"cuda:{first}"] + [f"cuda:{i}" for i in range(n) if i != first])


def global_bundle_adjust_auto(m: ms.MapState, cam_params, bf: float,
                              cam_model: int = 0, n_iters: int = 10, chunk: int = 5,
                              n_ba_points: Optional[int] = None,
                              should_abort: Optional[Callable[[], bool]] = None
                              ) -> ms.MapState:
    """Global BA on what the process has (reference :144-163): with more
    than one card the landmark-sharded `global_bundle_adjust_dist` over
    `gba_mesh`, with one card (or on the CPU) `global_bundle_adjust`."""
    mesh = gba_mesh(m.kf_R.device)
    if mesh is not None:
        return global_bundle_adjust_dist(m, cam_params, mesh, bf, cam_model=cam_model,
                                         n_iters=n_iters, chunk=chunk,
                                         n_ba_points=n_ba_points, should_abort=should_abort)
    return global_bundle_adjust(m, cam_params, bf, cam_model=cam_model, n_iters=n_iters,
                                chunk=chunk, n_ba_points=n_ba_points,
                                should_abort=should_abort)


def global_bundle_adjust_dist(m: ms.MapState, cam_params, mesh, bf: float,
                              cam_model: int = 0, n_iters: int = 10, chunk: int = 5,
                              n_ba_points: Optional[int] = None,
                              should_abort: Optional[Callable[[], bool]] = None
                              ) -> ms.MapState:
    """Full-map BA with the landmarks sharded over `mesh` (a
    `parallel.dist_ba.DeviceMesh` or `ProcessMesh`; reference :166-205):
    the problem is gathered and partitioned once, the LM schedule runs in
    chunks of `chunk` iterations of `dist_bundle_adjust` with
    `should_abort` polled between them (each chunk starts its chi2 gate
    afresh, as the reference's), then the landmark padding is dropped and
    the result scattered back into `m` (in place). The first valid keyframe
    is the gauge, as in `global_bundle_adjust`."""
    from ..parallel.dist_ba import dist_bundle_adjust, partition_problem
    K = m.max_kf
    dev = m.kf_R.device
    ii = torch.arange(K, dtype=torch.int32, device=dev)
    window_ids = torch.where(m.kf_valid, ii, -1)
    fixed = ii == torch.argmax(m.kf_valid.to(torch.int32))
    if n_ba_points is None:
        n_ba_points = m.max_mp
    prob, ids, sel_ids, cam_ok, pt_ok = _gather_window_problem(
        m, window_ids, fixed, bf, n_ba_points)
    probd = partition_problem(prob, mesh.size)
    done = 0
    while done < n_iters:
        it = min(chunk, n_iters - done)
        cam_R, cam_t, points, _ = dist_bundle_adjust(probd, cam_params, mesh,
                                                     cam_model=cam_model, bf=bf, n_iters=it)
        probd = probd._replace(cam_R=cam_R.to(dev), cam_t=cam_t.to(dev),
                               points=points.to(dev))
        done += it
        if should_abort is not None and should_abort():
            break
    return _scatter_window_result(m, probd.cam_R, probd.cam_t, probd.points[:n_ba_points],
                                  ids, sel_ids, cam_ok, pt_ok, fixed)


def merge_gba_result(m_now: ms.MapState, gba_R, gba_t, gba_mp_pos, n_kf0: int,
                     n_kf_now: int, mp_valid0, mp_first_kf0) -> ms.MapState:
    """Fold an asynchronous global BA's result into the map that kept
    moving while it ran (the tail of RunGlobalBundleAdjustment,
    LoopClosing.cc:1240+; reference :208-261). Returns `m_now` with new
    kf_R, kf_t and mp_pos tensors; reads nothing back to the host.

    Keyframes: ids are append-only between compactions and a compaction
    aborts the GBA, so the keyframes of the snapshot are the valid ones
    below `n_kf0` (its count at launch) and take the GBA's pose; those made
    since, `n_kf0 .. n_kf_now - 1` (host counts), are corrected by walking
    the spanning tree in id order (a parent precedes its child): each
    child's pose relative to its parent is kept on the parent's corrected
    pose.

    Landmarks: a slot's occupant is the one the GBA optimised when it was
    live at launch and is live now with the same first keyframe
    (`mp_valid0`, `mp_first_kf0`: the snapshot's); it takes the GBA's
    position. Every other live landmark re-anchors through its first
    keyframe's (before, after) pose pair. The reference instead takes the
    slots below the launch-time landmark count (`pp < n_mp0`, its :252):
    since slots are recycled (lowest free first) and the count is the live
    count, a landmark spawned during the GBA into a freed slot below it gets
    the dead occupant's GBA position, and one of the snapshot at a slot at
    or above it loses its own."""
    K = m_now.max_kf
    dev = m_now.kf_R.device
    in_gba = (torch.arange(K, device=dev) < n_kf0) & m_now.kf_valid
    R_new = torch.where(in_gba[:, None, None], gba_R, m_now.kf_R)
    t_new = torch.where(in_gba[:, None], gba_t, m_now.kf_t)
    for k in range(n_kf0, n_kf_now):
        par = m_now.kf_parent[k]
        parc = torch.clamp(par, 0, K - 1).long()
        Rpi, tpi = lie.se3_inverse(ms.row(m_now.kf_R, parc), ms.row(m_now.kf_t, parc))
        Rd, td = lie.se3_compose(m_now.kf_R[k], m_now.kf_t[k], Rpi, tpi)
        Rc, tc = lie.se3_compose(Rd, td, ms.row(R_new, parc), ms.row(t_new, parc))
        do = m_now.kf_valid[k] & (par >= 0)
        R_new[k] = torch.where(do, Rc, R_new[k])
        t_new[k] = torch.where(do, tc, t_new[k])

    in_gba_mp = mp_valid0 & m_now.mp_valid & (m_now.mp_first_kf == mp_first_kf0)
    ref = torch.clamp(m_now.mp_first_kf, 0, K - 1).long()
    has_ref = (m_now.mp_first_kf >= 0) & m_now.mp_valid
    p_cam = lie.se3_apply(m_now.kf_R[ref], m_now.kf_t[ref], m_now.mp_pos)
    p_re = torch.einsum("pji,pj->pi", R_new[ref], p_cam - t_new[ref])
    g = in_gba_mp.to(torch.float32)[:, None]
    h = (has_ref & ~in_gba_mp).to(torch.float32)[:, None]
    m_now.kf_R, m_now.kf_t = R_new, t_new
    m_now.mp_pos = g * gba_mp_pos + h * p_re + (1.0 - g - h) * m_now.mp_pos
    return m_now
