"""Device selection and numerics policy for the PyTorch port.

The JAX reference forces HIGHEST matmul precision package-wide
(`orbslam3lib_tpu/__init__.py:18-20`): its geometry (pose normal equations,
triangulation) fails in reduced-precision matmuls. The Hopper analogue of
the TPU's bf16 passes is TF32, which PyTorch enables for cuDNN convolutions
by default and may enable for matmuls; the port turns both off so every f32
product on the card is a full f32 product.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch


def set_numerics() -> None:
    """Full-f32 matmuls and convolutions on CUDA (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


set_numerics()


def get_device(name: str | torch.device) -> torch.device:
    """Return exactly the device asked for.

    Never picks the CPU silently: asking for "cuda" on a machine without a
    usable card raises instead of falling back.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A small host array on `dev` without the host waiting for the card: a
    copy from pageable memory (`torch.tensor(..., device=cuda)`) waits for
    the queue, one from pinned memory does not."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them: a card set below its
    maximum power runs slower under load, so every timing carries this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
