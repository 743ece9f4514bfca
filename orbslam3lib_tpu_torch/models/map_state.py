"""Tensor map model: keyframes + landmarks as fixed-capacity struct-of-arrays
(port of `orbslam3lib_tpu/models/map_state.py`, with `compact_map`).

Same fields, shapes and dtypes as the JAX `MapState`, so `from_numpy` /
`to_numpy` carry a map between the packages unchanged: it is the system's
state ("weights"), and the parity tests start both packages from one map.
The JAX package rebuilds the NamedTuple functionally on every update; here
the tensors are updated in place (index writes), which saves copying the
(K, F, 256) descriptor block and the other capacity-sized arrays at every
keyframe.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

MAX_KF = 256
MAX_MP = 16384


@dataclass
class MapState:
    # --- keyframes ---
    kf_R: torch.Tensor        # (K, 3, 3) world->cam
    kf_t: torch.Tensor        # (K, 3)
    kf_valid: torch.Tensor    # (K,) bool
    kf_ts: torch.Tensor       # (K,) f32 timestamps (map-relative)
    kf_xy: torch.Tensor       # (K, F, 2) level-0 keypoint coords
    kf_level: torch.Tensor    # (K, F) int32
    kf_angle: torch.Tensor    # (K, F) f32 keypoint orientations (rad)
    kf_desc: torch.Tensor     # (K, F, 256) int8 bits
    kf_feat_valid: torch.Tensor  # (K, F) bool
    kf_mp: torch.Tensor       # (K, F) int32 landmark id or -1
    kf_depth: torch.Tensor    # (K, F) f32 stereo depth (<= 0: none)
    kf_v: torch.Tensor        # (K, 3) body velocity (inertial state)
    kf_bg: torch.Tensor       # (K, 3) gyro bias
    kf_ba: torch.Tensor       # (K, 3) accel bias
    kf_parent: torch.Tensor   # (K,) int32 spanning-tree parent, -1 = root
    n_kf: torch.Tensor        # () int32
    # --- landmarks ---
    mp_pos: torch.Tensor      # (P, 3)
    mp_valid: torch.Tensor    # (P,) bool
    mp_desc: torch.Tensor     # (P, 256) int8 distinctive descriptor
    mp_normal: torch.Tensor   # (P, 3) mean viewing direction
    mp_min_dist: torch.Tensor  # (P,) scale-invariance range
    mp_max_dist: torch.Tensor  # (P,)
    mp_first_kf: torch.Tensor  # (P,) int32
    mp_found: torch.Tensor    # (P,) f32
    mp_visible: torch.Tensor  # (P,) f32
    n_mp: torch.Tensor        # () int32 live landmark count

    @property
    def max_kf(self) -> int:
        return self.kf_R.shape[0]

    @property
    def max_mp(self) -> int:
        return self.mp_pos.shape[0]

    @property
    def n_feat(self) -> int:
        return self.kf_xy.shape[1]


FIELDS = tuple(f.name for f in dataclasses.fields(MapState))


def empty_map(max_kf: int = MAX_KF, max_mp: int = MAX_MP, n_feat: int = 512,
              device: torch.device | str = "cpu") -> MapState:
    f32, i32 = torch.float32, torch.int32
    z = dict(device=device)
    return MapState(
        kf_R=torch.eye(3, dtype=f32, **z).repeat(max_kf, 1, 1),
        kf_t=torch.zeros((max_kf, 3), dtype=f32, **z),
        kf_valid=torch.zeros(max_kf, dtype=torch.bool, **z),
        kf_ts=torch.zeros(max_kf, dtype=f32, **z),
        kf_xy=torch.zeros((max_kf, n_feat, 2), dtype=f32, **z),
        kf_level=torch.zeros((max_kf, n_feat), dtype=i32, **z),
        kf_angle=torch.zeros((max_kf, n_feat), dtype=f32, **z),
        kf_desc=torch.zeros((max_kf, n_feat, 256), dtype=torch.int8, **z),
        kf_feat_valid=torch.zeros((max_kf, n_feat), dtype=torch.bool, **z),
        kf_mp=torch.full((max_kf, n_feat), -1, dtype=i32, **z),
        kf_depth=torch.zeros((max_kf, n_feat), dtype=f32, **z),
        kf_v=torch.zeros((max_kf, 3), dtype=f32, **z),
        kf_bg=torch.zeros((max_kf, 3), dtype=f32, **z),
        kf_ba=torch.zeros((max_kf, 3), dtype=f32, **z),
        kf_parent=torch.full((max_kf,), -1, dtype=i32, **z),
        n_kf=torch.zeros((), dtype=i32, **z),
        mp_pos=torch.zeros((max_mp, 3), dtype=f32, **z),
        mp_valid=torch.zeros(max_mp, dtype=torch.bool, **z),
        mp_desc=torch.zeros((max_mp, 256), dtype=torch.int8, **z),
        mp_normal=torch.zeros((max_mp, 3), dtype=f32, **z),
        mp_min_dist=torch.zeros(max_mp, dtype=f32, **z),
        mp_max_dist=torch.full((max_mp,), 1e9, dtype=f32, **z),
        mp_first_kf=torch.full((max_mp,), -1, dtype=i32, **z),
        mp_found=torch.ones(max_mp, dtype=f32, **z),
        mp_visible=torch.ones(max_mp, dtype=f32, **z),
        n_mp=torch.zeros((), dtype=i32, **z),
    )


def from_numpy(arrays: Dict[str, np.ndarray],
               device: torch.device | str = "cpu") -> MapState:
    """MapState from a dict of numpy arrays keyed by field name, e.g. a JAX
    map as `{k: np.asarray(v) for k, v in m._asdict().items()}`. Dtypes are
    kept as they are."""
    missing = set(FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"map arrays missing fields: {sorted(missing)}")
    return MapState(**{k: torch.from_numpy(np.array(arrays[k])).to(device)
                       for k in FIELDS})


def to_numpy(m: MapState) -> Dict[str, np.ndarray]:
    """Dict of numpy arrays keyed by field name (the inverse of from_numpy)."""
    return {k: getattr(m, k).cpu().numpy() for k in FIELDS}


def observation_matrix(m: MapState) -> torch.Tensor:
    """(K, P) f32 binary observation incidence from kf_mp: the tensor form of
    the reference's MapPoint::mObservations."""
    K, F = m.kf_mp.shape
    P = m.max_mp
    obs = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    kk = torch.arange(K, device=m.kf_mp.device)[:, None]
    flat = torch.where(obs, kk * P + m.kf_mp.long(), K * P).reshape(-1)
    O = torch.zeros(K * P + 1, device=m.kf_mp.device).index_add_(
        0, flat, torch.ones(flat.shape, device=flat.device))
    return O[:K * P].reshape(K, P).clamp(0.0, 1.0)


def covisibility(m: MapState) -> torch.Tensor:
    """(K, K) shared-observation counts, KeyFrame::UpdateConnections'
    covisibility weights: O @ O^T."""
    O = observation_matrix(m)
    return O @ O.T


def mp_observation_count(m: MapState) -> torch.Tensor:
    """(P,) int32 number of keyframes observing each landmark."""
    return observation_matrix(m).sum(dim=0).to(torch.int32)


def insert_keyframe(m: MapState, R, t, ts, xy, level, desc, feat_valid,
                    mp_assoc, depth, v=None, bg=None, ba=None, angle=None):
    """Write a keyframe into slot n_kf and register its observations, in
    place. mp_assoc (F,): landmark already matched to each feature (-1 if
    none). Returns (m, kf_id), kf_id -1 when the map is full (nothing is
    written). Reference: KeyFrame ctor + MapPoint::AddObservation +
    KeyFrame::UpdateConnections (Tracking::CreateNewKeyFrame)."""
    k = int(m.n_kf)
    if k >= m.max_kf:
        return m, -1
    dev = m.kf_R.device
    zeros3 = torch.zeros(3, dtype=torch.float32, device=dev)
    # spanning-tree parent: the earlier keyframe sharing the most landmarks
    assoc_eff = torch.where(feat_valid, mp_assoc, -1)
    tgt = torch.where(assoc_eff >= 0, assoc_eff, m.max_mp).long()
    obs_mask = torch.zeros(m.max_mp + 1, device=dev)
    obs_mask.index_fill_(0, tgt, 1.0)
    w = observation_matrix(m) @ obs_mask[:m.max_mp]
    w = w * m.kf_valid * (torch.arange(m.max_kf, device=dev) < k)
    parent = torch.where(torch.amax(w) > 0, torch.argmax(w), -1)

    m.kf_R[k] = R
    m.kf_t[k] = t
    m.kf_valid[k] = True
    m.kf_ts[k] = ts
    m.kf_xy[k] = xy
    m.kf_level[k] = level
    m.kf_angle[k] = angle if angle is not None else 0.0
    m.kf_desc[k] = desc
    m.kf_feat_valid[k] = feat_valid
    m.kf_mp[k] = assoc_eff
    m.kf_depth[k] = depth
    m.kf_v[k] = v if v is not None else zeros3
    m.kf_bg[k] = bg if bg is not None else zeros3
    m.kf_ba[k] = ba if ba is not None else zeros3
    m.kf_parent[k] = parent
    m.n_kf.fill_(k + 1)
    return m, k


def row(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x[k] for a 0-d index tensor, gathered on the device (no host read)."""
    return x.index_select(0, k.reshape(1).long())[0]


def set_row(x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """x[k] = v for a 0-d index tensor, written on the device."""
    x.index_copy_(0, k.reshape(1).long(), v[None])


def spawn_mappoints(m: MapState, kf_id, p_world, desc, normal, min_dist,
                    max_dist, want, feat_slot) -> MapState:
    """Allocate landmarks for the `want`-masked candidates (all (F,)) and bind
    them to keyframe `kf_id`'s feature slots `feat_slot`, in place. kf_id is
    an int or a 0-d tensor; nothing is read back to the host.

    Slots come from the free pool, lowest free index first, so culled slots
    are recycled; candidates beyond the free capacity are dropped. Fresh
    landmarks start at nFound = nVisible = 1 (MapPoint ctor). `n_mp` is the
    live landmark count.
    """
    F = want.shape[0]
    P = m.max_mp
    dev = want.device
    if not isinstance(kf_id, torch.Tensor):
        kf_id = torch.full((), kf_id, dtype=torch.int32, device=dev)
    free_score = torch.where(m.mp_valid, -1.0,
                             (P - torch.arange(P, device=dev)).to(torch.float32))
    slots = torch.sort(free_score, descending=True, stable=True).indices[:F]
    slot_free = ~m.mp_valid[slots]
    ranks = torch.clamp(torch.cumsum(want.to(torch.int32), 0) - 1, 0, F - 1)
    ids = slots[ranks]
    ok = want & slot_free[ranks]
    # landmark slot -> its candidate (the ok slots are distinct; the rest
    # land on the dropped slot P)
    src = torch.full((P + 1,), -1, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(ok, ids, P), torch.arange(F, device=dev))[:P]
    new = src >= 0
    s = torch.clamp(src, min=0)
    m.mp_pos = torch.where(new[:, None], p_world[s], m.mp_pos)
    m.mp_valid = m.mp_valid | new
    m.mp_desc = torch.where(new[:, None], desc[s], m.mp_desc)
    m.mp_normal = torch.where(new[:, None], normal[s], m.mp_normal)
    m.mp_min_dist = torch.where(new, min_dist[s], m.mp_min_dist)
    m.mp_max_dist = torch.where(new, max_dist[s], m.mp_max_dist)
    m.mp_first_kf = torch.where(new, kf_id.to(torch.int32), m.mp_first_kf)
    m.mp_found = torch.where(new, 1.0, m.mp_found)
    m.mp_visible = torch.where(new, 1.0, m.mp_visible)
    m.n_mp = m.mp_valid.sum(dtype=torch.int32)
    r = row(m.kf_mp, kf_id)
    r[feat_slot] = torch.where(ok, ids.to(torch.int32), r[feat_slot])
    set_row(m.kf_mp, kf_id, r)
    return m


def compact_map(m: MapState):
    """Recycle culled keyframe and landmark slots by stable compaction
    (reference :257-350). A fixed-capacity map must reclaim dead slots or
    keyframe insertion stops at max_kf. Valid keyframes, and landmarks that
    are valid and observed by at least one valid keyframe, slide down to the
    low slots in their order (ids stay in temporal order, which the
    essential-graph chain and the covisibility windows rely on); every
    cross-reference (kf_mp, kf_parent, mp_first_kf) is rewritten.

    Returns (new map, kf_new (K,) old -> new keyframe id or -1, mp_new (P,)
    old -> new landmark id or -1), all on the map's device; the host-side
    ids are remapped through them by the caller."""
    K, P = m.max_kf, m.max_mp
    dev = m.kf_R.device
    i32 = torch.int32

    def old_of_new(live, n):
        # new slot -> old slot for the `live` mask (rank order), 0 past the end
        rank = torch.cumsum(live.to(i32), 0) - 1
        new = torch.where(live, rank, -1)
        old = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_(
            0, torch.where(live, rank, n).long(), torch.arange(n, device=dev))[:n]
        return new.to(i32), old

    kf_new, kf_old = old_of_new(m.kf_valid, K)
    n_kf2 = m.kf_valid.sum(dtype=i32)
    obs = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    obs_alive = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    obs_alive.index_fill_(0, torch.where(obs, m.kf_mp, P).reshape(-1).long(), True)
    mp_live = m.mp_valid & obs_alive[:P]
    mp_new, mp_old = old_of_new(mp_live, P)
    n_mp2 = mp_live.sum(dtype=i32)
    live_kf = torch.arange(K, device=dev) < n_kf2
    live_mp = torch.arange(P, device=dev) < n_mp2

    def gk(arr, fill=0):
        shape = (K,) + (1,) * (arr.dim() - 1)
        return torch.where(live_kf.reshape(shape), arr[kf_old],
                           torch.full_like(arr[kf_old], fill))

    def gp(arr, fill=0):
        shape = (P,) + (1,) * (arr.dim() - 1)
        return torch.where(live_mp.reshape(shape), arr[mp_old],
                           torch.full_like(arr[mp_old], fill))

    def remap(ids, table, n):
        return torch.where(ids >= 0, table[torch.clamp(ids, 0, n - 1).long()], -1)

    kf_mp2 = remap(m.kf_mp[kf_old], mp_new, P)
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(K, 3, 3)
    m2 = MapState(
        kf_R=torch.where(live_kf[:, None, None], m.kf_R[kf_old], eye),
        kf_t=gk(m.kf_t), kf_valid=live_kf, kf_ts=gk(m.kf_ts),
        kf_xy=gk(m.kf_xy), kf_level=gk(m.kf_level), kf_angle=gk(m.kf_angle),
        kf_desc=gk(m.kf_desc),
        kf_feat_valid=gk(m.kf_feat_valid) & live_kf[:, None],
        kf_mp=torch.where(live_kf[:, None], kf_mp2, -1).to(i32),
        kf_depth=gk(m.kf_depth), kf_v=gk(m.kf_v), kf_bg=gk(m.kf_bg),
        kf_ba=gk(m.kf_ba),
        kf_parent=torch.where(live_kf, remap(m.kf_parent[kf_old], kf_new, K), -1).to(i32),
        n_kf=n_kf2,
        mp_pos=gp(m.mp_pos), mp_valid=live_mp, mp_desc=gp(m.mp_desc),
        mp_normal=gp(m.mp_normal), mp_min_dist=gp(m.mp_min_dist),
        mp_max_dist=gp(m.mp_max_dist, 1e9),
        mp_first_kf=torch.where(live_mp, remap(m.mp_first_kf[mp_old], kf_new, K), -1).to(i32),
        mp_found=gp(m.mp_found, 1.0), mp_visible=gp(m.mp_visible, 1.0),
        n_mp=n_mp2)
    return m2, kf_new, mp_new
