"""`vi_window_ms`: median (ms) over the window's keyframes made outside the
profiled slice of the back end's `mapping.vi_window` span (the windowed
visual-inertial BA of `Tracker._run_vi_window`); the windows that VIBA1
and VIBA2 run inside `mapping.full_vi_ba` are left out. On the device's
timeline, where the card records one. Nothing when no such span fell in
the window."""
from slambench.harness import spans


def read(run):
    recs = spans.untraced(run)
    by_id = {r["id"]: r for r in recs}
    return spans.median_ms([spans.seconds(r) for r in recs if r["name"] == "mapping.vi_window"
                            and not spans.under(by_id, r, "mapping.full_vi_ba")])
