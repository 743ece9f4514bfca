"""The card's published peaks and the bytes each measured kernel must move.

Peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet): 3.35 TB/s of
HBM and 67 TFLOP/s in float32 outside the tensor cores. A kernel's share of
its roofline is the least time its bytes (or operations) take at these
rates over its measured device time.
"""
from __future__ import annotations

from ..reference.pyramid import level_shapes

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

FAST_NMS_KERNEL = "fast_nms_levels_kernel"


def fast_nms_bytes(height: int, width: int, n_levels: int, batch: int = 2) -> int:
    """Kernel 1 (FAST score + 3x3 NMS over every pyramid level of a batch of
    images, one launch): each float32 pixel of every level read once and its
    score written once, 8 bytes a pixel."""
    return 8 * batch * sum(h * w for h, w in level_shapes(height, width, n_levels))


def bound_seconds(n_bytes: float) -> float:
    """The least time `n_bytes` take at the HBM peak."""
    return n_bytes / HBM_BYTES_PER_S
