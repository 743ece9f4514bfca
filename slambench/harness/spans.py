"""The program's spans as the per-layer readers take them.

The tracker's timer keeps its span log in `samples["spans"]`, which the
runner clears at the window's start and copies into `RunRecords.stages`
after it; `records` resolves it with the port's `export_spans`, imported
only when the log holds spans, since the benchmark also runs over programs
that keep none (they leave the key out, and every reader then returns
nothing). Spans of the profiled frames are left out (the profiler slows
them), matched by frame id: the program's frame id is the frame's index in
the sequence, as the run starts the tracker at frame 0 and hands it every
frame. A span's time is its device-timeline time where the card recorded
one, else its host time.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from . import trace

KEY = "spans"
PREFIX = "orbslam."


def records(run) -> List[dict]:
    """The window's span records in `export_spans`'s form (records handed
    in as such pass through)."""
    log = list(run.stages.get(KEY) or ())
    if log and not isinstance(log[0], dict):
        from orbslam3lib_tpu_torch.utils.timing import export_spans
        log = export_spans(log)
    return log


def seconds(r: dict) -> float:
    return r["device_s"] if r.get("device_s") is not None else r["host_s"]


def untraced(run) -> List[dict]:
    """Span records of the frames outside the profiled slice."""
    traced = {f.index for f in run.frames if f.traced}
    return [r for r in records(run) if r["frame"] not in traced]


def each(recs: List[dict], name: str) -> List[float]:
    """Seconds of every span `name` among `recs`."""
    return [seconds(r) for r in recs if r["name"] == name]


def per_frame(recs: List[dict], name: str) -> List[float]:
    """Seconds of the spans `name` among `recs` summed over each frame that
    has one."""
    tot: Dict[int, float] = defaultdict(float)
    for r in recs:
        if r["name"] == name:
            tot[r["frame"]] += seconds(r)
    return list(tot.values())


def under(by_id: Dict[int, dict], r: dict, name: str) -> bool:
    """Whether span `r` lies inside a span `name` of its thread (`by_id`:
    the records by id)."""
    p = by_id.get(r["parent"])
    while p is not None:
        if p["name"] == name:
            return True
        p = by_id.get(p["parent"])
    return False


def median_ms(values: List[float]) -> Optional[float]:
    return float(np.median(values)) * 1e3 if values else None


def _overlap(a: List[trace.Interval], b: List[trace.Interval]) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _subtract(a: List[trace.Interval], b: List[trace.Interval]) -> List[trace.Interval]:
    """The parts of sorted disjoint intervals `a` outside sorted disjoint
    intervals `b`."""
    out = []
    j = 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append((lo, b[k][0]))
            lo = max(lo, b[k][1])
            k += 1
        if hi > lo:
            out.append((lo, hi))
    return out


def idle_pct_inside(tr, match: Callable[[str], bool],
                    exclude: Callable[[str], bool] = lambda name: False) -> Optional[float]:
    """Share (%) of the time inside the profiled slice's spans whose
    annotation name matches, less the time inside those that `exclude`
    names, in which no kernel, copy or memset ran: that set against the
    union of device activity, both clipped to the slice's wall span.
    Nothing when no such time is left."""
    if tr is None:
        return None
    w0, w1 = tr.window
    inside = _subtract(trace.union([(a, b) for name, a, b in tr.host if match(name)], w0, w1),
                       trace.union([(a, b) for name, a, b in tr.host if exclude(name)], w0, w1))
    total = sum(b - a for a, b in inside)
    if total <= 0.0:
        return None
    busy = trace.union([(a, b) for _, a, b in tr.device], w0, w1)
    return 100.0 * (1.0 - _overlap(inside, busy) / total)
