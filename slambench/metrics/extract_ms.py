"""`extract_ms`: median (ms) over the window's frames of the stage timer's
`extract` stage, `ops.extractor`: the remap of a raw rig, the pyramid,
kernel 1, orientation and BRIEF of both eyes. With its timer on (traced
runs only) the tracker ends each stage with a device sync."""
import numpy as np

STAGE = "extract"


def read(run):
    s = run.stages.get(STAGE)
    return float(np.median(s)) * 1e3 if s else None
