"""`keyframe_frame_ms`: median host-clock latency (ms) of the window's
frames that made a keyframe (the tracker's `n_kf` grew), outside the
profiled slice: the mapper step, local BA and, on an inertial rig, the VI
window run inline in them (`mapping`). Nothing when no such frame ran."""
import numpy as np


def read(run):
    ms = [f.ms for f in run.untraced() if f.kf]
    return float(np.median(ms)) if ms else None
