"""Map-level bundle adjustment (port of `orbslam3lib_tpu/mapping/map_ba.py`).

Only `inv_sigma2` is ported so far: the pose solve of stereo tracking needs
it. The window and global BA come with the mapper chain.
"""
from __future__ import annotations

import torch

from ..ops.pyramid import scale_factors


def inv_sigma2(level: torch.Tensor, n_levels: int = 8) -> torch.Tensor:
    """Per-observation information 1/scale^2 (the reference's
    mvInvLevelSigma2, Frame.cc)."""
    sf = torch.from_numpy(scale_factors(n_levels)).to(level.device)
    s = sf[torch.clamp(level, 0, n_levels - 1).long()]
    return 1.0 / (s * s)
