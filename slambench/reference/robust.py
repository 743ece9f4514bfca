"""Robust kernels for the optimizers (port of `orbslam3lib_tpu/utils/robust.py`;
reference: g2o RobustKernelHuber, Optimizer.cc:962-967 chi2/Huber gates)."""
from __future__ import annotations

import math

import torch

# chi2 gates from the reference (Optimizer.cc:984-998)
CHI2_MONO = 5.991    # 2-dof 95%
CHI2_STEREO = 7.815  # 3-dof 95%
DELTA_MONO = math.sqrt(CHI2_MONO)
DELTA_STEREO = math.sqrt(CHI2_STEREO)


def huber_weight(chi2: torch.Tensor, delta) -> torch.Tensor:
    """IRLS weight for the Huber kernel at squared error chi2:
    1 for |e| <= delta, delta/|e| beyond."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)
