"""Reduction of a `torch.profiler` trace to the numbers the per-layer
metrics read: device activity intervals, host launch calls, the frames of
the traced slice, and the breakdown (top device operations, longest idle
gaps and what the host was doing in each).

The profiler's events are read in memory (`kineto_results.events()`); no
chrome trace is written. Device time is the union of the intervals of
kernels, copies and memsets on the timeline, so overlapping work counts
once.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

FRAME_SPAN = "slambench.frame"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls that put work on the device: one each
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
                "cuLaunchKernel", "cuLaunchKernelEx")

Interval = Tuple[float, float]


@dataclass
class Trace:
    """Times in seconds on the profiler's clock. `device`: (name, start,
    end) of each device activity; `frames`: (start, end) of each frame span;
    `host`: (name, start, end) of each host operation (for the gaps);
    `launches`: host launch calls inside the frames."""
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    frames: List[Interval] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    launches: int = 0

    @property
    def window(self) -> Interval:
        return (self.frames[0][0], self.frames[-1][1]) if self.frames else (0.0, 0.0)


def _kind(e, name: str) -> str:
    """The event's activity type, worked out from its device and name (the
    profiler's events carry no activity type of their own)."""
    on_device = str(e.device_type()).endswith("CUDA")
    ann = name == FRAME_SPAN or e.is_user_annotation()
    if on_device:
        if ann:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if ann:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def from_profiler(prof) -> Trace:
    """The events of a stopped `torch.profiler.profile`."""
    tr = Trace()
    launch_times = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        kind = _kind(e, name)
        t0 = e.start_ns() * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        if kind in DEVICE_KINDS:
            tr.device.append((name, t0, t1))
        elif kind == "user_annotation" and name == FRAME_SPAN:
            tr.frames.append((t0, t1))
        elif kind.startswith("cuda_"):      # runtime and lower-level API calls
            if name in LAUNCH_CALLS:
                launch_times.append(t0)
            tr.host.append((name, t0, t1))
        elif kind in ("cpu_op", "user_annotation", "python_function"):
            tr.host.append((name, t0, t1))
    tr.frames.sort()
    tr.device.sort(key=lambda x: x[1])
    w0, w1 = tr.window
    tr.launches = sum(1 for t in launch_times if w0 <= t <= w1)
    return tr


def union(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of intervals clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(tr: Trace) -> float:
    w0, w1 = tr.window
    return sum(b - a for a, b in union([(a, b) for _, a, b in tr.device], w0, w1))


def idle_share(tr: Trace) -> float | None:
    """Share of the slice's wall span in which no device activity ran."""
    w0, w1 = tr.window
    if w1 <= w0:
        return None
    return 1.0 - busy_seconds(tr) / (w1 - w0)


def gaps(tr: Trace) -> List[Interval]:
    """The idle intervals of the slice, longest first."""
    w0, w1 = tr.window
    busy = union([(a, b) for _, a, b in tr.device], w0, w1)
    out, cur = [], w0
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        out.append((cur, w1))
    return sorted(out, key=lambda g: g[0] - g[1])


def host_at(tr: Trace, t: float) -> str:
    """The innermost host operation running at time t (the shortest span
    that holds it), other than the frame span itself."""
    best, best_len = "host (no recorded operation)", float("inf")
    for name, a, b in tr.host:
        if a <= t <= b and name != FRAME_SPAN and b - a < best_len:
            best, best_len = name, b - a
    return best


def device_totals(tr: Trace) -> Dict[str, Tuple[float, int]]:
    """Device seconds and count per operation name inside the slice."""
    w0, w1 = tr.window
    tot: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, a, b in tr.device:
        if a >= w0 and b <= w1:
            tot[name][0] += b - a
            tot[name][1] += 1
    return {k: (v[0], int(v[1])) for k, v in tot.items()}


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by what the host was doing in their middle."""
    tot = sorted(device_totals(tr).items(), key=lambda kv: -kv[1][0])[:n]
    idle = [[f"idle in {host_at(tr, 0.5 * (a + b))}", b - a] for a, b in gaps(tr)[:n]]
    return {"device_ops": [[k, v[0]] for k, v in tot], "idle_gaps": idle}
