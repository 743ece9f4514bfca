"""Atlas: the multi-map container, its Sim(3) map transform and the map
merge (port of `orbslam3lib_tpu/models/atlas.py`; ORB-SLAM3's Atlas.cc
CreateNewMap / SetMapBad / RemoveBadMaps and the map fusion of
LoopClosing::MergeLocal).

A lost map of more than 10 keyframes is archived here, not dropped
(Tracking::CreateMapInAtlas): the tracker starts a new current map, and a
later revisit merges the archived one into it through the Sim(3) that the
map merger verified (`mapping/loop_closing.MapMerger`).

Maps are fixed-capacity `MapState`s on the Atlas's device. `transform_map`
returns a new map; `merge_into` writes into `dst` in place (the port's
maps are updated in place, see `map_state`).

Three faults of the reference are not carried over:
- its `merge_into` clips a source landmark's rank to the last free slot
  (`atlas.py:69-72`), so when the source holds more landmarks than `dst`
  has slots, every landmark past the end is written to that one slot and
  the keyframes observing them point at it; here they are dropped;
- its `merge_into` drops the keyframes past `dst`'s last keyframe slot but
  keeps the landmarks they created, whose `mp_first_kf` then names an id
  >= max_kf, which the tracker's and the culling's age tests read as
  recent forever; here those landmarks are dropped (and a parent link to
  a dropped keyframe cleared);
- its `remove_bad_maps` finds the current map with `list.index` over maps
  of arrays (`atlas.py:158-163`), which compares arrays and raises with
  three maps or more (so any merge with two archives raises); here the
  current map's index is counted.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..ops.fast import topk_stable
from ..utils import lie
from . import map_state as ms


def transform_map(m: ms.MapState, R12, t12, s12) -> ms.MapState:
    """The map moved by a world-frame Sim(3) S = (R12, t12, s12), target <-
    source (Map::ApplyScaledRotation): landmarks p' = s R p + t, keyframe
    poses T_cw' = T_cw o S^-1 (rigid, the translation divided by the
    scale), velocities v' = s R v. Invalid landmarks keep their positions.
    Returns a new MapState sharing the unchanged fields with `m`."""
    s12 = torch.as_tensor(s12, dtype=torch.float32, device=m.mp_pos.device)
    p_new = s12 * (m.mp_pos @ R12.T) + t12
    Ri, ti, si = lie.sim3_inverse(R12, t12, s12)
    K = m.max_kf
    one = torch.ones(K, dtype=torch.float32, device=m.kf_R.device)
    Rn, tn, sn = lie.sim3_compose(m.kf_R, m.kf_t, one, Ri.expand(K, 3, 3),
                                  ti.expand(K, 3), si.expand(K))
    kf_t = tn / torch.clamp(sn[:, None], min=1e-9)
    kf_v = s12 * (m.kf_v @ R12.T)
    mp_pos = torch.where(m.mp_valid[:, None], p_new, m.mp_pos)
    return dataclasses.replace(m, kf_R=Rn, kf_t=kf_t, kf_v=kf_v, mp_pos=mp_pos)


def _scatter_rows(dst: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor) -> None:
    """dst[tgt] = vals in place, rows with tgt == len(dst) dropped (the
    reference's `.at[tgt].set(mode="drop")`; only dropped rows repeat)."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    buf.index_copy_(0, tgt.long(), vals.to(dst.dtype))
    dst.copy_(buf[:n])


def merge_into(dst: ms.MapState, src: ms.MapState) -> ms.MapState:
    """Copy src's valid keyframes and landmarks into dst, in place (src must
    already be in dst's world, through `transform_map`). Keyframes are
    appended at dst.n_kf in their order (the essential graph and the
    covisibility windows rely on temporal ids); landmarks go into dst's
    free slots, lowest first. `kf_mp`, `mp_first_kf` and `kf_parent` are
    remapped to the new ids. What does not fit is dropped: keyframes past
    max_kf, with the landmarks they created and the parent links to them,
    and landmarks past the last free slot. Returns dst."""
    dev = dst.kf_R.device
    K, F = src.kf_mp.shape
    P = src.max_mp
    i32 = torch.int32
    kf_off = dst.n_kf.to(torch.int64)

    kf_rank = torch.cumsum(src.kf_valid.to(torch.int64), 0) - 1
    kf_new = torch.where(src.kf_valid, kf_off + kf_rank,
                         torch.full_like(kf_rank, dst.max_kf))
    kf_ok = src.kf_valid & (kf_new < dst.max_kf)
    kf_tgt = torch.where(kf_ok, kf_new, torch.full_like(kf_new, dst.max_kf))
    # a source keyframe id -> its id in dst; >= max_kf: dropped (overflow)
    first_new = kf_off + kf_rank[torch.clamp(src.mp_first_kf, 0, K - 1).long()]
    parent_new = kf_off + kf_rank[torch.clamp(src.kf_parent, 0, K - 1).long()]
    first_dropped = (src.mp_first_kf >= 0) & (first_new >= dst.max_kf)
    mp_keep = src.mp_valid & ~first_dropped

    # dst's free slots, lowest index first (topk_stable: the tie order of
    # lax.top_k among the occupied slots)
    free_score = torch.where(
        dst.mp_valid, torch.full((dst.max_mp,), -1.0, device=dev),
        (dst.max_mp - torch.arange(dst.max_mp, device=dev)).to(torch.float32))
    L = min(P, dst.max_mp)
    _, fslots = topk_stable(free_score, L)
    fslot_free = ~dst.mp_valid[fslots]
    mp_rank = torch.cumsum(mp_keep.to(torch.int64), 0) - 1
    rank_c = torch.clamp(mp_rank, 0, L - 1)
    mp_ok = mp_keep & (mp_rank < L) & fslot_free[rank_c]
    mp_tgt = torch.where(mp_ok, fslots[rank_c], torch.full_like(rank_c, dst.max_mp))

    remap = torch.where(mp_ok, mp_tgt, torch.full_like(mp_tgt, -1)).to(i32)
    src_kf_mp = torch.where(src.kf_mp >= 0,
                            remap[torch.clamp(src.kf_mp, 0, P - 1).long()],
                            torch.full_like(src.kf_mp, -1))
    kf_first_remap = torch.where(src.mp_first_kf >= 0, first_new.to(i32),
                                 torch.full_like(src.mp_first_kf, -1))
    kf_parent_remap = torch.where((src.kf_parent >= 0) & (parent_new < dst.max_kf),
                                  parent_new.to(i32), torch.full_like(src.kf_parent, -1))

    def masked(x, ok):
        return torch.where(ok.reshape(ok.shape + (1,) * (x.dim() - 1)), x,
                           torch.zeros_like(x))

    for name in ("kf_R", "kf_t", "kf_ts", "kf_xy", "kf_level", "kf_angle", "kf_desc",
                 "kf_feat_valid", "kf_depth", "kf_v", "kf_bg", "kf_ba"):
        _scatter_rows(getattr(dst, name), kf_tgt, masked(getattr(src, name), kf_ok))
    _scatter_rows(dst.kf_valid, kf_tgt, kf_ok)
    _scatter_rows(dst.kf_mp, kf_tgt,
                  torch.where(kf_ok[:, None], src_kf_mp, torch.full_like(src_kf_mp, -1)))
    _scatter_rows(dst.kf_parent, kf_tgt,
                  torch.where(kf_ok, kf_parent_remap, torch.full_like(kf_parent_remap, -1)))
    dst.n_kf = (dst.n_kf + kf_ok.sum()).to(i32)

    for name in ("mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist",
                 "mp_found", "mp_visible"):
        _scatter_rows(getattr(dst, name), mp_tgt, masked(getattr(src, name), mp_ok))
    _scatter_rows(dst.mp_valid, mp_tgt, mp_ok)
    _scatter_rows(dst.mp_first_kf, mp_tgt,
                  torch.where(mp_ok, kf_first_remap, torch.full_like(kf_first_remap, -1)))
    dst.n_mp = dst.mp_valid.sum().to(i32)
    return dst


class Atlas:
    """The maps of one SLAM run (Atlas.h:45-141): a list of maps, one of them
    current, on one device. `create_new_map` starts an empty map and makes
    it current; `merge` welds a map into the current one and removes it."""

    def __init__(self, max_kf: int = ms.MAX_KF, max_mp: int = ms.MAX_MP,
                 n_feat: int = 512, device: torch.device | str = "cpu"):
        self._dims = (max_kf, max_mp, n_feat)
        self.device = torch.device(device)
        self.maps: List[ms.MapState] = [self._empty()]
        self.bad: List[bool] = [False]
        self.current = 0

    def _empty(self) -> ms.MapState:
        return ms.empty_map(*self._dims, device=self.device)

    @property
    def current_map(self) -> ms.MapState:
        return self.maps[self.current]

    @current_map.setter
    def current_map(self, m: ms.MapState):
        self.maps[self.current] = m

    def create_new_map(self) -> int:
        """Tracking::CreateMapInAtlas: an empty map, made current. Returns
        its index."""
        self.maps.append(self._empty())
        self.bad.append(False)
        self.current = len(self.maps) - 1
        return self.current

    def set_map_bad(self, idx: int) -> None:
        if idx == self.current:
            raise ValueError("the current map cannot be set bad")
        self.bad[idx] = True

    def remove_bad_maps(self) -> None:
        """Drop the maps set bad; the current map keeps being current (its
        index counted down past the removed ones)."""
        self.current -= sum(self.bad[:self.current])
        self.maps = [m for m, b in zip(self.maps, self.bad) if not b]
        self.bad = [False] * len(self.maps)

    def count_maps(self) -> int:
        return len(self.maps)

    def merge(self, src_idx: int, R12, t12, s12) -> None:
        """Weld map `src_idx` into the current map through the world-frame
        Sim(3) (current <- src), then remove it (LoopClosing::MergeLocal's
        map fusion)."""
        src = transform_map(self.maps[src_idx], R12, t12, s12)
        merge_into(self.current_map, src)
        self.set_map_bad(src_idx)
        self.remove_bad_maps()
