"""`mapping_device_idle_pct`: in the profiled slice, the share (%) of the
time inside the program's `orbslam.mapping.*` spans (the mapper step, local
BA, the VI windows, the full VI BA and the merge check) in which no kernel,
copy or memset ran, the union of their intervals as `device_idle_pct`
takes it. Nothing when the slice holds no such span."""
from slambench.harness import spans


def read(run):
    return spans.idle_pct_inside(run.trace,
                                 lambda name: name.startswith(spans.PREFIX + "mapping."))
