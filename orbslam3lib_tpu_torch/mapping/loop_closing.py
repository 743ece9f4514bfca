"""The per-keyframe mapper step (port of
`orbslam3lib_tpu/mapping/loop_closing.py:527-569`, `mapper_step_fused`).

Only the step without the loop-candidate probe is ported: `loop_probe`,
the loop verification and the correction come with the loop leg.
"""
from __future__ import annotations

import torch

from ..models import map_state as ms
from ..models.vocabulary import _descend, bow_vector
from .local_mapping import _index, mapping_step


def mapper_step_fused(m: ms.MapState, bow_db, active, centroids, idf, kf_id,
                      cam_params, k: int, depth: int, n_best: int = 3,
                      cam_model: int = 0, img_w: int = 640, img_h: int = 400,
                      n_levels: int = 8, n_tri: int = 10, n_fuse: int = 3,
                      do_cull_kf: bool = True, with_probe: bool = False,
                      th_far=None, prev_cand=None):
    """The per-keyframe mapper chain: ComputeBoW and the database add
    (LocalMapping::ProcessNewKeyFrame, LocalMapping.cc:304), then
    `mapping_step`. Updates `m`, `bow_db` and `active` in place, reads
    nothing back to the host.

    Returns (m, bow_db, active, pack (16,)); the pack is [probe (3 n_best +
    2, all -1 without a probe) | n_mp | n_kf | zeros], as in the reference.
    """
    if with_probe:
        raise NotImplementedError(
            "the loop-candidate probe (loop_probe) is not ported yet: it comes "
            "with the loop-closing port (ROADMAP queue 1, item 8)")
    kf_id = _index(kf_id, bow_db.device)
    words = _descend(centroids, ms.row(m.kf_desc, kf_id), k, depth)
    v = bow_vector(words, ms.row(m.kf_feat_valid, kf_id), idf, k ** depth)
    ms.set_row(bow_db, kf_id, v)
    ms.set_row(active, kf_id, torch.ones((), dtype=torch.bool, device=active.device))
    mapping_step(m, kf_id, cam_params, cam_model=cam_model, img_w=img_w,
                 img_h=img_h, n_levels=n_levels, n_tri=n_tri, n_fuse=n_fuse,
                 do_cull_kf=do_cull_kf, th_far=th_far)
    probe = torch.full((3 * n_best + 2,), -1.0, device=bow_db.device)
    aux = torch.stack([m.n_mp.to(torch.float32), m.n_kf.to(torch.float32)])
    pack = torch.cat([probe, aux, torch.zeros(16 - probe.shape[0] - 2,
                                              device=bow_db.device)])
    return m, bow_db, active, pack
