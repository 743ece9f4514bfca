"""`mapper_locked_ms`: median (ms) over the window's keyframes made outside
the profiled slice of the time the mapper thread held the map lock for
each, its `mapping.locked` intervals summed (the mapper step, the local
BA's window, snapshot and write-back, the loop leg; not the local BA's
solve, which runs with the lock released): on the host clock. Nothing when
no such interval fell in the window (no mapper thread, or a program
without the interval)."""
from slambench.harness import spans


def read(run):
    held = [r for r in spans.untraced(run) if r["name"] == "mapping.locked"]
    per_kf = {}
    for r in held:
        per_kf[r["frame"]] = per_kf.get(r["frame"], 0.0) + r["host_s"]
    return spans.median_ms(list(per_kf.values()))
