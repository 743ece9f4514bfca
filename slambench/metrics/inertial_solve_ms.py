"""`inertial_solve_ms`: median (ms) over the window's frames outside the
profiled slice of the frame's `track.inertial_solve` span, the per-frame
visual-inertial solve (`Tracker._inertial_refine`, from its CUDA graph):
on the device's timeline, where the card records one. Nothing when no such
span fell in the window."""
from slambench.harness import spans


def read(run):
    return spans.median_ms(spans.per_frame(spans.untraced(run), "track.inertial_solve"))
