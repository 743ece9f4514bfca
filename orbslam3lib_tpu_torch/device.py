"""Device selection and numerics policy for the PyTorch port.

The JAX reference forces HIGHEST matmul precision package-wide
(`orbslam3lib_tpu/__init__.py:18-20`): its geometry (pose normal equations,
triangulation) fails in reduced-precision matmuls. The Hopper analogue of
the TPU's bf16 passes is TF32, which PyTorch enables for cuDNN convolutions
by default and may enable for matmuls; the port turns both off so every f32
product on the card is a full f32 product.
"""
from __future__ import annotations

import contextlib
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


def on_device(dev: torch.device):
    """Context in which the calling thread's current card is `dev` (a new
    thread starts on card 0); nothing to do for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def to_host(x) -> np.ndarray:
    """A tensor's values as a numpy array (waits for the card); an array
    as it is."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them: a card set below its
    maximum power runs slower under load, so every timing carries this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms_per_launch(launch, n: int = 200, warm: int = 10,
                         graph: bool = False) -> float:
    """Device time per call of `launch()` in ms: CUDA events around n
    back-to-back calls, after `warm` calls, divided by n. With `graph` the n
    calls are captured once into a CUDA graph and the events bracket one
    replay, so the host's cost of enqueueing a call cannot stretch the
    reading; without it, a call that the host enqueues slower than the card
    runs it reads the host's rate."""
    for _ in range(warm):
        launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                launch()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(n):
            launch()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


class GraphedCall:
    """`fn(*tensors) -> tuple of tensors`, replayed from a CUDA graph on the
    card: one graph per input signature (shapes and dtypes), captured at
    the first call with it, after two warm-up calls on a side stream; each
    call copies its inputs into the graph's static buffers, replays it on
    the current stream and returns clones of the static outputs. fn must
    run the same operations for every input of a signature and never read
    the card from the host. On CPU tensors fn runs as it is.

    A capture that fails (an operation a graph cannot hold) leaves that
    signature running fn eagerly on the same card, its reason kept in
    `eager` (nothing moves to the CPU). Capture is thread-local, so the
    mapper and GBA threads go on launching meanwhile."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs: dict = {}
        self.eager: dict = {}

    def __call__(self, *tensors):
        if tensors[0].device.type != "cuda":
            return self.fn(*tensors)
        key = tuple((tuple(t.shape), t.dtype) for t in tensors)
        if key in self.eager:
            return self.fn(*tensors)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self._capture(key, tensors)
            if entry is None:
                return self.fn(*tensors)
        graph, static_in, static_out = entry
        for dst, src in zip(static_in, tensors):
            dst.copy_(src)
        graph.replay()
        return tuple(o.clone() for o in static_out)

    def _capture(self, key, tensors):
        static_in = [t.clone() for t in tensors]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.fn(*static_in)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = tuple(self.fn(*static_in))
        except RuntimeError as e:
            torch.cuda.current_stream().wait_stream(side)
            self.eager[key] = repr(e)
            return None
        self.graphs[key] = (graph, static_in, static_out)
        return self.graphs[key]

