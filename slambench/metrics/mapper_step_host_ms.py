"""`mapper_step_host_ms`: median (ms) over the window's keyframes made
outside the profiled slice of their `mapping.mapper_step` span
(`mapper_step_ms`'s span: `mapper_step_fused`, which the mapper thread runs
holding the map lock) on the host clock, for a deployment whose threads
share the one stream. Nothing when no such span fell in the window."""
from slambench.harness import spans


def read(run):
    return spans.median_ms([r["host_s"] for r in spans.untraced(run)
                            if r["name"] == "mapping.mapper_step"])
