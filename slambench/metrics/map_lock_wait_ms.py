"""`map_lock_wait_ms`: mean (ms) over the window's frames outside the
profiled slice of each frame's `track.lock_wait` spans (`Tracker.
_process_frame`'s wait for the map lock that the mapper thread holds while
it maps a keyframe), a frame without one counting 0: on the host clock,
since a device-event pair on the stream the threads share would time the
other thread's kernels too. Nothing when no such span fell in the window
(a program without the span)."""
from collections import defaultdict

from slambench.harness import spans


def read(run):
    waits = defaultdict(float)
    for r in spans.untraced(run):
        if r["name"] == "track.lock_wait":
            waits[r["frame"]] += r["host_s"]
    frames = run.untraced()
    if not waits or not frames:
        return None
    return 1e3 * sum(waits.get(f.index, 0.0) for f in frames) / len(frames)
