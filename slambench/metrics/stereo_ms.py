"""`stereo_ms`: median (ms) over the window's frames of the stage timer's
`stereo_match` stage, `tracking.matching`: rectified stereo matching and
the SAD refinement. With its timer on (traced runs only) the tracker ends
each stage with a device sync."""
import numpy as np

STAGE = "stereo_match"


def read(run):
    s = run.stages.get(STAGE)
    return float(np.median(s)) * 1e3 if s else None
