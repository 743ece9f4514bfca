"""The data-parallel front end: a batch of stereo frames split over a mesh
(port of `orbslam3lib_tpu/parallel/dist_frontend.py`).

Each shard runs extraction and rectified stereo matching on its own frames,
on its own device, with no communication: the frame axis is embarrassingly
parallel. Within a shard all frames' images go through
`extract_orb_stereo` as one batch, so kernel 1 launches once per shard on
the card, over every level of every image. For offline and multi-session
map building (each device ingests its own frames) and dataset
preprocessing.
"""
from __future__ import annotations

from dataclasses import fields

import torch

from ..ops.extractor import Features, extract_orb_stereo
from ..tracking.matching import match_rectified_stereo
from .dist_ba import DeviceMesh


def make_sharded_frontend(mesh: DeviceMesh, bf: float = 33.0, min_z: float = 0.3,
                          max_kp: int = 512, n_levels: int = 8):
    """A frame-batched front end over `mesh` (a `dist_ba.DeviceMesh`;
    reference :41-58).

    Returns fn(imgs (N, 2, H, W), thresholds (N,)) -> a list over the
    shards of (Features with leading dims (N / n_shards, 2), u_r (N /
    n_shards, F), depth (N / n_shards, F)), each on its shard's device:
    shard s holds frames s * N / n_shards onwards. N must be a multiple of
    the mesh's size."""
    def frontend(imgs, thresholds):
        imgs = torch.as_tensor(imgs)
        thresholds = torch.as_tensor(thresholds, dtype=torch.float32)
        N = imgs.shape[0]
        if N % mesh.size:
            raise ValueError(f"{N} frames do not split into {mesh.size} shards")
        per = N // mesh.size
        out = []
        for s, dev in enumerate(mesh.devices):
            im = imgs[s * per:(s + 1) * per].to(dev, torch.float32)
            th = thresholds[s * per:(s + 1) * per].to(dev)
            # every image of the shard in one batch: one launch of kernel 1
            f = extract_orb_stereo(im.reshape((2 * per,) + im.shape[2:]),
                                   th.repeat_interleave(2), max_kp=max_kp,
                                   n_levels=n_levels)
            feats = Features(*(getattr(f, fl.name).reshape((per, 2) + getattr(
                f, fl.name).shape[1:]) for fl in fields(Features)))
            ur, depth = zip(*(match_rectified_stereo(
                feats.xy[i, 0], feats.level[i, 0], feats.desc[i, 0], feats.valid[i, 0],
                feats.xy[i, 1], feats.level[i, 1], feats.desc[i, 1], feats.valid[i, 1],
                bf, min_z, n_levels=n_levels) for i in range(per)))
            out.append((feats, torch.stack(ur), torch.stack(depth)))
        return out

    return frontend
