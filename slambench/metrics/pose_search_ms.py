"""`pose_search_ms`: median (ms) over the window's frames outside the
profiled slice of the frame's summed `track.search` spans, the
`tracking.tracker` layer's two-stage projection search and pose solve
(`_two_stage_core`, again after a reference-keyframe fallback): on the
device's timeline, where the card records one. Nothing when no such span
fell in the window (a program without spans)."""
from slambench.harness import spans


def read(run):
    return spans.median_ms(spans.per_frame(spans.untraced(run), "track.search"))
