"""`device_idle_pct`: share (%) of the profiled slice's wall span (first
frame's call to last frame's return) in which no kernel, copy or memset
ran: one minus the union of their intervals on the timeline over the span."""
from slambench.harness import trace


def read(run):
    if run.trace is None:
        return None
    idle = trace.idle_share(run.trace)
    return None if idle is None else 100.0 * idle
