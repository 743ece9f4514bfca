"""`pose_track_ms`: median (ms) over the window's frames of the stage
timer's `track` stage, `Tracker._track`: the two-stage projection search
and pose solves, the inertial solve where there is one, and on a keyframe
frame the back end that runs inline. With its timer on (traced runs only)
the tracker ends each stage with a device sync."""
import numpy as np

STAGE = "track"


def read(run):
    s = run.stages.get(STAGE)
    return float(np.median(s)) * 1e3 if s else None
