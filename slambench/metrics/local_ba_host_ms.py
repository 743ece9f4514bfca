"""`local_ba_host_ms`: median (ms) over the window's keyframes made outside
the profiled slice of their `mapping.local_ba` span (`local_ba_ms`'s span:
on the mapper thread the window, the snapshot, the solve with the map lock
released, the lock taken again and the write-back) on the host clock, for
a deployment whose threads share the one stream. Nothing when no such span
fell in the window."""
from slambench.harness import spans


def read(run):
    return spans.median_ms([r["host_s"] for r in spans.untraced(run)
                            if r["name"] == "mapping.local_ba"])
