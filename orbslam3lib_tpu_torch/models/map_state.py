"""Tensor map model: keyframes + landmarks as fixed-capacity struct-of-arrays
(port of `orbslam3lib_tpu/models/map_state.py:31-253`; `compact_map` is not
ported yet).

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
