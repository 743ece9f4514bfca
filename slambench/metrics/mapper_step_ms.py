"""`mapper_step_ms`: median (ms) over the window's keyframes made outside
the profiled slice of their `mapping.mapper_step` span (`mapper_step_fused`:
BoW add, landmark culling, triangulation, fusion, keyframe culling and the
loop probe as one queue of device work): on the device's timeline, where
the card records one. Nothing when no such span fell in the window."""
from slambench.harness import spans


def read(run):
    return spans.median_ms(spans.each(spans.untraced(run), "mapping.mapper_step"))
