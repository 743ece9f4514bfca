"""The write-back of a local BA solved on a snapshot of the map into the map
that moved on while it ran, written plainly, one keyframe and one landmark
at a time. It follows the reference's LocalBundleAdjustment
(Optimizer.cc:1124), which solves without Map::mMutexMapUpdate and takes it
only to write the result back: each optimised keyframe takes its pose, each
optimised landmark that is not bad takes its position; keyframes made
since are not moved.

Rules, by identity:
- a keyframe of the window that is live in the snapshot, not fixed, and
  still live now takes its optimised pose (keyframe slots are not reused
  within one map epoch);
- the optimised landmarks are the live landmarks of the snapshot observed
  through a valid feature of a live window keyframe, the lowest ids first,
  at most `n_ba_points` of them; each takes its optimised position when its
  slot still holds it: live now, with the snapshot's first keyframe (a slot
  freed and given to a new landmark in between holds another one).

Nothing here imports the port, JAX or the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch

LIVE_FIELDS = ("kf_R", "kf_t", "kf_valid", "mp_pos", "mp_valid", "mp_first_kf")
SNAPSHOT_FIELDS = ("kf_R", "kf_t", "kf_valid", "kf_feat_valid", "kf_mp", "mp_pos",
                   "mp_valid", "mp_first_kf")


def optimised_landmarks(snap: Dict[str, torch.Tensor], window_ids, n_ba_points: int):
    """The landmark ids the solve optimised, in increasing order."""
    seen = set()
    for k in window_ids.tolist():
        if k < 0 or not bool(snap["kf_valid"][k]):
            continue
        for f, p in enumerate(snap["kf_mp"][k].tolist()):
            if p >= 0 and bool(snap["kf_feat_valid"][k, f]):
                seen.add(p)
    return sorted(p for p in seen if bool(snap["mp_valid"][p]))[:n_ba_points]


def writeback(live: Dict[str, torch.Tensor], snap: Dict[str, torch.Tensor], window_ids,
              fixed_mask, n_ba_points: int) -> Dict[str, torch.Tensor]:
    """The live map's `LIVE_FIELDS` after the write-back. `live`: the map as
    it stands when the solve returns; `snap`: the snapshot the solve read
    (`SNAPSHOT_FIELDS`), its `kf_R`, `kf_t` and `mp_pos` as the solve left
    them; `window_ids` (C,) keyframe ids, -1 for an empty slot;
    `fixed_mask` (C,) the window's fixed keyframes."""
    out = {k: live[k].clone() for k in LIVE_FIELDS}
    for k, fixed in zip(window_ids.tolist(), fixed_mask.tolist()):
        if k < 0 or fixed or not bool(snap["kf_valid"][k]) or not bool(live["kf_valid"][k]):
            continue
        out["kf_R"][k] = snap["kf_R"][k]
        out["kf_t"][k] = snap["kf_t"][k]
    for p in optimised_landmarks(snap, window_ids, n_ba_points):
        if bool(live["mp_valid"][p]) and int(live["mp_first_kf"][p]) == int(snap["mp_first_kf"][p]):
            out["mp_pos"][p] = snap["mp_pos"][p]
    return out
