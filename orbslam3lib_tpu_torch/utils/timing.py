"""Per-stage timing, spans and levelled logging.

`StageTimer` began as a copy of `orbslam3lib_tpu/utils/timing.py` (the
reference's REGISTER_TIMES machinery: per-stage vectors dumped by
Tracking::PrintTimeStats, and the Verbose printer, System.h:49-74), and is
the port's one recorder of where a frame's time goes.

Stages. `timer.stage(name)` times a stage of the frame (`extract`,
`stereo_match`, `track`; the pipelined path's `pipeline_dispatch` and
`pipeline_finalize`) and appends its host seconds to `samples[name]`. Work
on the card is asynchronous, so a caller that wants the card's time inside
a stage waits for its results before the stage ends (the tracker does, when
its timer is on). A stage is also a span.

Spans. `timer.span(name, frame=None, **counts)` marks one layer's work in a
frame or in its keyframe's back end, and waits for nothing. Each span keeps
its name; the id of the frame it serves (`frame`, else its parent's, else
-1); its parent, the innermost open span of the same thread; its host start
and end (`time.perf_counter_ns`); on the card, a pair of timing events
recorded on the current stream at entry and exit; and counts that are
already on the host (`counts`, or later `Span.set`; never a tensor's
value). It is also a `torch.profiler.record_function` named
`orbslam.<name>`, so that in a profiled run the spans lie on the kernels'
clock. The events are resolved only by `export()`, after the run, so a span
adds no sync: its device time runs from its start event to its end event on
the stream's timeline, and so counts the host's stalls and the device work
queued inside the span, where the host clock without a sync counts only the
enqueue.

Intervals. `timer.interval(name, frame=None)` marks a stretch that need not
nest with the thread's spans, such as a lock held from one layer's work
into another's: a span on the host clock alone (no device events, no
profiler annotation) that is never pushed on the thread's stack, so it has
no parent and is no span's parent, and may open and close at any point of
the thread's spans (it is entered and left by hand where a `with` cannot
hold it). Its frame is the one given, else the innermost open span's.

The spans are kept in `samples[SPANS]`, in the order they opened, so that
clearing `samples` starts the stages and the spans anew. The recorder may be
used from several threads (the mapper's, the global BA's): each keeps its
own stack of open spans.

Off (`enabled` False, the default), `stage` and `span` read one attribute
and return the shared `NO_SPAN`, which records nothing: no event, no
`record_function`, no entry in `samples`.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

SPANS = "spans"               # the key of the span log in `samples`
ANNOTATION_PREFIX = "orbslam."


class Verbose:
    QUIET, NORMAL, VERBOSE, DEBUG = 0, 1, 2, 3
    level = QUIET

    @classmethod
    def log(cls, msg: str, lvl: int = 1):
        if lvl <= cls.level:
            print(msg, flush=True)


class _NoSpan:
    """What `span` and `stage` return with the timer off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts):
        pass


NO_SPAN = _NoSpan()


class Span:
    """One span of an enabled `StageTimer` (see the module's docstring),
    its own context manager."""
    __slots__ = ("name", "frame", "parent", "counts", "t0_ns", "t1_ns",
                 "_timer", "_stage", "_nested", "_events", "_annotation")

    def __init__(self, timer: "StageTimer", name: str, frame: Optional[int],
                 counts: dict, stage: bool, nested: bool = True):
        self.name, self.frame, self.counts = name, frame, counts
        self.parent: Optional[Span] = None
        self.t0_ns = self.t1_ns = None
        self._timer, self._stage, self._nested = timer, stage, nested
        self._events = self._annotation = None

    def set(self, **counts):
        """Add host counts to the span (never a tensor's value)."""
        self.counts.update(counts)

    def __enter__(self):
        tm = self._timer
        stack = tm._stack()
        top = stack[-1] if stack else None
        if self.frame is None:
            self.frame = top.frame if top is not None else -1
        with tm._lock:
            tm.samples[SPANS].append(self)
        if self._nested:
            self.parent = top
            stack.append(self)
            self._annotation = torch.autograd.profiler.record_function(
                ANNOTATION_PREFIX + self.name)
            self._annotation.__enter__()
            if tm.cuda and not torch.cuda.is_current_stream_capturing():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.perf_counter_ns()
        tm = self._timer
        if self._nested:
            if self._events is not None:
                self._events[1].record()
            self._annotation.__exit__(*exc)
            self._annotation = None
            tm._stack().pop()
        if self._stage:
            with tm._lock:
                tm.samples[self.name].append((self.t1_ns - self.t0_ns) * 1e-9)
        return False

    def device_seconds(self) -> Optional[float]:
        """The span on the device's timeline (waits for its end event), or
        None without events."""
        if self._events is None:
            return None
        e0, e1 = self._events
        e1.synchronize()
        return e0.elapsed_time(e1) * 1e-3


def export_spans(spans: List[Span]) -> List[dict]:
    """The closed spans of a log as records, in the order they opened:
    `id` (the span's place in the log), `name`, `frame`, `parent` (the
    parent's id, None for a root or a parent outside the log), `start_ns`
    and `end_ns` (host), `host_s`, `device_s` (None without events) and
    `counts`. Resolves the device times: call it after the run."""
    index = {id(s): i for i, s in enumerate(spans)}
    out = []
    for i, s in enumerate(spans):
        if s.t1_ns is None:
            continue
        out.append({"id": i, "name": s.name, "frame": s.frame,
                    "parent": index.get(id(s.parent)) if s.parent is not None else None,
                    "start_ns": s.t0_ns, "end_ns": s.t1_ns,
                    "host_s": (s.t1_ns - s.t0_ns) * 1e-9,
                    "device_s": s.device_seconds(), "counts": dict(s.counts)})
    return out


class StageTimer:
    """Per-stage durations and spans (see the module's docstring); off, it
    records nothing (REGISTER_TIMES is a compile-time switch in the
    reference). `device`: where the timed work runs; on a CUDA device each
    span also records a pair of timing events."""

    def __init__(self, enabled: bool = False, device=None):
        self.enabled = enabled
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.samples: Dict[str, list] = defaultdict(list)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, frame: Optional[int] = None, **counts):
        if not self.enabled:
            return NO_SPAN
        return Span(self, name, frame, counts, stage=False)

    def stage(self, name: str):
        if not self.enabled:
            return NO_SPAN
        return Span(self, name, None, {}, stage=True)

    def interval(self, name: str, frame: Optional[int] = None):
        if not self.enabled:
            return NO_SPAN
        return Span(self, name, frame, {}, stage=False, nested=False)

    def export(self) -> List[dict]:
        """`export_spans` of this timer's log."""
        with self._lock:
            spans = list(self.samples.get(SPANS, ()))
        return export_spans(spans)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.samples.items():
            if not v or k == SPANS:
                continue
            s = sorted(v)
            out[k] = {
                "mean_ms": 1e3 * sum(v) / len(v),
                "median_ms": 1e3 * s[len(s) // 2],
                "p95_ms": 1e3 * s[min(len(s) - 1, int(len(s) * 0.95))],
                "count": len(v),
            }
        return out

    def print_time_stats(self):
        """PrintTimeStats-style dump (Tracking.cc:263)."""
        for k, st in sorted(self.summary().items()):
            print(f"{k:30s} mean {st['mean_ms']:8.3f} ms  "
                  f"median {st['median_ms']:8.3f} ms  "
                  f"p95 {st['p95_ms']:8.3f} ms  n={st['count']}")
