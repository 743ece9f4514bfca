"""`local_ba_ms`: median (ms) over the window's keyframes made outside the
profiled slice of their `mapping.local_ba` span (`Tracker._run_local_ba`:
the covisibility window and the BA over it): on the device's timeline,
where the card records one. Nothing when no such span fell in the
window."""
from slambench.harness import spans


def read(run):
    return spans.median_ms(spans.each(spans.untraced(run), "mapping.local_ba"))
