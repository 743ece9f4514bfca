"""Fused FAST-9/16 score + 3x3 NMS: the wrapper of kernel 1
(`csrc/fast_nms.cu`), the port of `orbslam3lib_tpu/ops/pallas_fast.py`.

On a CPU tensor it returns the plain version, `fast.nms3x3(fast.fast_scores
(img, margin))`; on a CUDA tensor it launches the kernel or raises. The two
agree bit for bit (see the source's note).
"""
from __future__ import annotations

import torch

from . import _cuda_lib, fast

launches = 0   # kernel launches made by this process (see chip_smoke.py)


def reset_count() -> None:
    global launches
    launches = 0


def fast_scores_nms_plain(img: torch.Tensor, margin: int) -> torch.Tensor:
    return fast.nms3x3(fast.fast_scores(img.to(torch.float32), margin=margin))


def fast_scores_nms(img: torch.Tensor, margin: int = 3) -> torch.Tensor:
    """NMS'd exact FAST-9/16 score map of (H, W) or (B, H, W) f32/uint8
    images: (..., H, W) f32, score kept only at 3x3 local maxima, margin
    rows/columns zeroed. `margin` must be >= 3 (the ring radius)."""
    if margin < 3:
        raise ValueError(f"margin must be >= 3 (the FAST ring radius), got {margin}")
    if img.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got shape {tuple(img.shape)}")
    if img.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"expected float32 or uint8, got {img.dtype}")
    if img.device.type == "cpu":
        return fast_scores_nms_plain(img, margin)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    global launches
    x = img.to(torch.float32).contiguous()
    batch = 1 if x.dim() == 2 else x.shape[0]
    h, w = x.shape[-2:]
    out = torch.empty_like(x)
    lib = _cuda_lib.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fast_nms_launch(x.data_ptr(), out.data_ptr(), batch, h, w,
                                  margin, stream)
    _cuda_lib.check(err, "fast_nms_launch")
    launches += 1
    return out
