"""`track_frame_ms`: median host-clock latency (ms) of the window's frames
that made no keyframe and closed no loop (`tracking.tracker`), outside the
profiled slice."""
import numpy as np


def read(run):
    ms = [f.ms for f in run.untraced() if not f.kf and not f.loop]
    return float(np.median(ms)) if ms else None
