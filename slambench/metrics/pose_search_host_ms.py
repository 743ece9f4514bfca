"""`pose_search_host_ms`: median (ms) over the window's frames outside the
profiled slice of the frame's summed `track.search` spans (`pose_search_ms`'s
spans: the two-stage projection search and pose solve) on the host clock,
for a deployment whose threads share the one stream, where a span's device
events would time the other threads' kernels too. Nothing when no such span
fell in the window."""
from collections import defaultdict

from slambench.harness import spans


def read(run):
    tot = defaultdict(float)
    for r in spans.untraced(run):
        if r["name"] == "track.search":
            tot[r["frame"]] += r["host_s"]
    return spans.median_ms(list(tot.values()))
