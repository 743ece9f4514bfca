"""`gba_thread_ms`: median (ms) of the window's `loop.gba_thread` spans that
closed in it (`Tracker._maybe_start_gba`'s thread: the global BA after a
loop, from its start to its merge or abort), profiled slice or not, on the
host clock. Nothing when none closed in the window."""
from slambench.harness import spans


def read(run):
    return spans.median_ms([r["host_s"] for r in spans.records(run)
                            if r["name"] == "loop.gba_thread"])
