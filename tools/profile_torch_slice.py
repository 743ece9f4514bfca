"""Where the time of the PyTorch port's stereo SLAM slice goes, on one
CUDA card.

    python3 tools/profile_torch_slice.py [--out FILE]

Renders bench.py's orbit sequence (its world and 640x400 rig), drives
`Tracker.process_frame` over it with bench.py's tracking configuration (as
chip_smoke.py does, without its jolt), and after WARM frames:
  * times STEADY frames on the host clock, synchronised per frame, with the
    profiler off (ms per frame);
  * profiles the next STEADY frames with torch.profiler: device busy time
    per frame (the sum of CUDA kernel and copy events, each counted once),
    the device's idle share against the un-profiled frame time, device
    events and cudaLaunchKernel calls per frame, the port's own kernels by
    name (calls per frame, device ms per call), and the tables of
    key_averages() by device and by host time;
  * profiles one more run of the per-keyframe back end
    (`Tracker._mapping_pipeline`) on the last keyframe: its host time,
    device busy time, device events and cudaLaunchKernel calls.
The summary line goes to stdout; the tables to --out (default: stdout).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

WARM, STEADY = 30, 15
PORT_KERNELS = ("fast_nms_levels_kernel", "knn2_kernel")


def device_counts(ka):
    """(device busy ms, device events, cudaLaunchKernel calls) of a
    key_averages() table. Device events only for the busy time: the aten ops
    that launched them carry the same device time again."""
    on_dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in on_dev) / 1e3,
            sum(e.count for e in on_dev),
            sum(e.count for e in ka if e.key == "cudaLaunchKernel"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="file for the profiler tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from orbslam3lib_tpu_torch.device import card_line
    from orbslam3lib_tpu_torch.io.synthetic import (orbit_tracking_config,
                                                    render_orbit_sequence)
    from orbslam3lib_tpu_torch.tracking.tracker import Tracker

    dev = torch.device("cuda:0")
    imgs, ts, rig = render_orbit_sequence(WARM + 2 * STEADY)
    tr = Tracker(orbit_tracking_config(rig), "stereo", device=dev,
                 enable_loop_closing=False)
    for i in range(WARM):
        tr.process_frame(imgs[i], float(ts[i]))
    torch.cuda.synchronize()

    frame_ms = []
    for i in range(WARM, WARM + STEADY):
        t0 = time.perf_counter()
        tr.process_frame(imgs[i], float(ts[i]))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(frame_ms))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(WARM + STEADY, WARM + 2 * STEADY):
            tr.process_frame(imgs[i], float(ts[i]))
        torch.cuda.synchronize()
    ka = prof.key_averages()
    busy_ms, n_dev, n_launch = (x / STEADY for x in device_counts(ka))

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as kf_prof:
        tr._mapping_pipeline(tr.last_kf_id)
        torch.cuda.synchronize()
    kf_ms = (time.perf_counter() - t0) * 1e3
    kf_busy, kf_dev, kf_launch = device_counts(kf_prof.key_averages())

    print(card_line())
    print(f"un-profiled {wall_ms:.3f} ms/frame (median of {STEADY}); device busy "
          f"{busy_ms:.3f} ms/frame; idle share {1.0 - busy_ms / wall_ms:.3f}; "
          f"device events {n_dev:.0f}/frame; cudaLaunchKernel {n_launch:.0f}/frame; "
          f"stats {tr.stats}")
    ours = {k: [0, 0.0] for k in PORT_KERNELS}
    for e in ka:
        for k in PORT_KERNELS:
            if k in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
                ours[k][0] += e.count
                ours[k][1] += e.self_device_time_total / 1e3
    print("port kernels (profiled): " + "; ".join(
        f"{k} {n / STEADY:.2f} calls/frame, "
        + (f"{ms / n:.5f} ms device per call" if n else "not run")
        for k, (n, ms) in ours.items()))
    print(f"back end of one keyframe (profiled): {kf_ms:.3f} ms host; device busy "
          f"{kf_busy:.3f} ms; device events {kf_dev:.0f}; cudaLaunchKernel "
          f"{kf_launch:.0f}")
    tables = (ka.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60) + "\n"
              + ka.table(sort_by="self_cpu_time_total", row_limit=30,
                         max_name_column_width=60))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(tables)
    else:
        print(tables)
    return 0


if __name__ == "__main__":
    sys.exit(main())
