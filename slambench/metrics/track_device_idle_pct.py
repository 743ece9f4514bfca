"""`track_device_idle_pct`: in the profiled slice, the share (%) of the time
inside the program's `orbslam.track` spans (the `track` stage, which ends
with a device sync), less the time inside `orbslam.keyframe.backend` (the
back end a keyframe frame runs inline, which `mapping_device_idle_pct` and
the loop's spans cover), in which no kernel, copy or memset ran, device
activity taken as `device_idle_pct` takes it. Nothing when the slice holds
no such time."""
from slambench.harness import spans


def read(run):
    return spans.idle_pct_inside(run.trace, lambda name: name == spans.PREFIX + "track",
                                 exclude=lambda name: name == spans.PREFIX + "keyframe.backend")
