"""What a run records, and the arithmetic of the window: the end-to-end
metrics and the records that the per-layer readers (`metrics/*.py`) take."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class FrameRecord:
    """One frame of the window: its sequence index, host-clock latency from
    the call to its return (ms), start and end (s from the window's start),
    whether it made a keyframe, closed a loop, failed (counted by the
    tracker or a pose that is not finite), and ran under the profiler."""
    index: int
    ms: float
    start: float
    end: float
    kf: bool
    loop: bool
    fail: bool
    traced: bool = False


@dataclass
class RunRecords:
    frames: List[FrameRecord]
    window_s: float
    stages: Dict[str, List[float]] = field(default_factory=dict)
    stats_delta: Dict[str, float] = field(default_factory=dict)
    trace: Optional[object] = None          # trace.Trace of the profiled slice
    config: dict = field(default_factory=dict)

    def completed(self) -> int:
        """Frames whose call returned inside the window."""
        return sum(1 for f in self.frames if f.end <= self.window_s)

    def end_to_end(self, setup_s: float) -> Dict[str, float]:
        """fps over the window's wall time (a stall counts); the median and
        95th percentile of every window frame's latency; set-up seconds."""
        ms = np.asarray([f.ms for f in self.frames], np.float64)
        return {"fps": self.completed() / self.window_s,
                "frame_ms_p50": float(np.percentile(ms, 50)) if len(ms) else float("nan"),
                "frame_ms_p95": float(np.percentile(ms, 95)) if len(ms) else float("nan"),
                "setup_s": float(setup_s)}

    def untraced(self) -> List[FrameRecord]:
        """Window frames outside the profiled slice (the profiler slows
        those it records)."""
        return [f for f in self.frames if not f.traced]
