"""Fused Hamming kNN-2: the wrapper of kernel 2 (`csrc/knn2.cu`), the port
of `orbslam3lib_tpu/ops/pallas_matcher.py`.

Same contract as the JAX `knn_match_fused`: (best (Na,) int32, d1, d2 (Na,)
f32), BIG on invalid B columns inside the kernel and on invalid A rows
afterwards, lowest column on ties. On a CPU tensor it returns the plain
`matcher.knn_match`; on a CUDA tensor it launches the kernel (one launch,
which packs the bits itself: no scratch) or raises.
"""
from __future__ import annotations

import torch

from . import _cuda_lib, matcher

launches = 0   # kernel launches made by this process (see chip_smoke.py)


def reset_count() -> None:
    global launches
    launches = 0


def _check_bits(name: str, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] != 256:
        raise ValueError(f"{name}: expected (N, 256) bits, got {tuple(x.shape)}")
    if x.dtype != torch.int8:
        raise TypeError(f"{name}: expected int8 0/1 bits, got {x.dtype}")
    if x.shape[0] < 1:
        raise ValueError(f"{name}: needs at least one row")


def _check_valid(name: str, v, n: int, device) -> torch.Tensor | None:
    if v is None:
        return None
    if v.dtype != torch.bool or v.shape != (n,):
        raise ValueError(f"{name}: expected ({n},) bool, got {tuple(v.shape)} {v.dtype}")
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, bits on {device}")
    return v.contiguous().view(torch.uint8)


def knn_match_fused(a_bits: torch.Tensor, b_bits: torch.Tensor,
                    a_valid: torch.Tensor | None = None,
                    b_valid: torch.Tensor | None = None):
    """Brute-force Hamming kNN-2 a -> b: (best, d1, d2), each (Na,)."""
    _check_bits("a_bits", a_bits)
    _check_bits("b_bits", b_bits)
    if a_bits.device != b_bits.device:
        raise ValueError(f"a_bits on {a_bits.device}, b_bits on {b_bits.device}")
    if a_bits.device.type == "cpu":
        return matcher.knn_match(a_bits, b_bits, a_valid, b_valid)
    if a_bits.device.type != "cuda":
        raise ValueError(f"unsupported device {a_bits.device}")
    dev = a_bits.device
    av = _check_valid("a_valid", a_valid, a_bits.shape[0], dev)
    bv = _check_valid("b_valid", b_valid, b_bits.shape[0], dev)
    out, launch = prepare_launch(a_bits.contiguous(), b_bits.contiguous(), av, bv)
    launch()
    return out


def prepare_launch(a: torch.Tensor, b: torch.Tensor, av: torch.Tensor | None,
                   bv: torch.Tensor | None):
    """((best, d1, d2), launch) for checked contiguous CUDA bits and uint8
    masks (or None): `launch()` runs the kernel once on the current stream
    and counts the launch. `knn_match_fused` calls it once; a timing loop
    may call it many times on the same buffers."""
    dev, na, nb = a.device, a.shape[0], b.shape[0]
    best = torch.empty(na, dtype=torch.int32, device=dev)
    d1 = torch.empty(na, dtype=torch.float32, device=dev)
    d2 = torch.empty(na, dtype=torch.float32, device=dev)
    lib = _cuda_lib.library()
    ptrs = (a.data_ptr(), b.data_ptr(), av.data_ptr() if av is not None else None,
            bv.data_ptr() if bv is not None else None, na, nb,
            best.data_ptr(), d1.data_ptr(), d2.data_ptr())

    def launch() -> None:
        global launches
        with torch.cuda.device(dev):
            err = lib.knn2_launch(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
        _cuda_lib.check(err, "knn2_launch")
        launches += 1

    return (best, d1, d2), launch
