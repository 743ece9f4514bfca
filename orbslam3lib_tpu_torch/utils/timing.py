"""Per-stage timing and levelled logging (a copy of
`orbslam3lib_tpu/utils/timing.py`, which cannot be imported without JAX).

The reference's equivalents are the REGISTER_TIMES machinery (per-stage
vectors dumped by Tracking::PrintTimeStats) and the Verbose printer
(System.h:49-74). `StageTimer` records host wall time per named stage;
work on the card is asynchronous, so a caller that wants the card's time
inside a stage must wait for its results before the stage ends (the
tracker does, when its timer is on).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List


class Verbose:
    QUIET, NORMAL, VERBOSE, DEBUG = 0, 1, 2, 3
    level = QUIET

    @classmethod
    def log(cls, msg: str, lvl: int = 1):
        if lvl <= cls.level:
            print(msg, flush=True)


class StageTimer:
    """Accumulates per-stage durations; off, it records nothing (REGISTER_TIMES
    is a compile-time switch in the reference)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self._open: Dict[str, float] = {}

    def start(self, stage: str):
        if self.enabled:
            self._open[stage] = time.perf_counter()

    def stop(self, stage: str):
        if self.enabled and stage in self._open:
            self.samples[stage].append(time.perf_counter() - self._open.pop(stage))

    class _Ctx:
        def __init__(self, timer, stage):
            self.timer, self.stage = timer, stage

        def __enter__(self):
            self.timer.start(self.stage)

        def __exit__(self, *a):
            self.timer.stop(self.stage)

    def stage(self, name: str) -> "_Ctx":
        return StageTimer._Ctx(self, name)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.samples.items():
            if not v:
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
