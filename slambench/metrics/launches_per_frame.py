"""`launches_per_frame`: host calls that launch device work (kernels and
graph replays: `cudaLaunchKernel`, `cudaLaunchKernelExC`, `cudaGraphLaunch`)
in the profiled slice, per frame of the slice."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    return run.trace.launches / len(run.trace.frames)
