"""Two versions of the port's stereo slice on the same card and frames, in
turns: per-frame time and kernel launches of each.

    python3 tools/ab_slice.py --tree parent=DIR --tree change=. \
        [--order parent,change,change,parent] [--frames 400]

Each --tree names a checkout of the repo (for an earlier commit, unpack
`git archive <commit>` into a directory that .gitignore lists). The tool
renders bench.py's room orbit once (this checkout's renderer, 640x400),
then runs each entry of --order in a process of its own that imports only
that checkout's `orbslam3lib_tpu_torch`: it builds the checkout's kernels
and drives `Tracker.process_frame` over the frames with bench.py's
tracking configuration and loop closing on (chip_smoke.py's phase 3
without its jolt and kidnap). Per run it prints one JSON line: the host
time per frame (synchronised per frame; median and p90 over the frames
outside the profiled window), and, from torch.profiler over PROFILED
frames starting at PROFILE_AT, cudaLaunchKernel calls and device events
per frame; then keyframes, loops and failures.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

PROFILE_AT, PROFILED = 100, 60


def worker(root: str, frames_file: str, label: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import orbslam3lib_tpu_torch as pkg
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, orbit_tracking_config
    from orbslam3lib_tpu_torch.ops import _cuda_lib
    from orbslam3lib_tpu_torch.tracking.tracker import Tracker

    assert os.path.abspath(pkg.__file__).startswith(os.path.abspath(root)), pkg.__file__
    dev = torch.device("cuda:0")
    build_s = _cuda_lib.build()
    data = np.load(frames_file)
    imgs, ts = data["imgs"], data["ts"]
    tr = Tracker(orbit_tracking_config(StereoRig()), "stereo", device=dev)
    frame_ms, prof = [], None
    for i in range(len(imgs)):
        if i == PROFILE_AT:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        tr.process_frame(imgs[i], float(ts[i]))
        torch.cuda.synchronize()
        if not PROFILE_AT <= i < PROFILE_AT + PROFILED:
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i == PROFILE_AT + PROFILED - 1:
            prof.__exit__(None, None, None)
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    dev_events = sum(e.count for e in ka
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    st = tr.stats
    print(json.dumps({
        "label": label, "root": root, "build_s": build_s, "frames": len(imgs),
        "median_ms": float(np.median(frame_ms)),
        "p90_ms": float(np.percentile(frame_ms, 90)),
        "mean_ms": float(np.mean(frame_ms)),
        "launches_per_frame": launches / PROFILED,
        "device_events_per_frame": dev_events / PROFILED,
        "profiled_frames": [PROFILE_AT, PROFILE_AT + PROFILED],
        "n_kf": st["n_kf"], "n_loops": st["n_loops"],
        "track_fail": st["track_fail"]}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="LABEL=DIR, a checkout of the repo")
    ap.add_argument("--order", help="comma-separated labels (default: each once)")
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(*args.worker)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from orbslam3lib_tpu_torch.device import card_line
    from orbslam3lib_tpu_torch.io.synthetic import render_orbit_sequence

    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    t0 = time.perf_counter()
    imgs, ts, _ = render_orbit_sequence(args.frames)
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    frames_file = os.path.join(here, "build", "ab_slice_frames.npz")
    np.savez(frames_file, imgs=imgs, ts=ts)
    print(f"{card_line()}; rendered {args.frames} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rc = 0
    try:
        for label in order:
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", "x=.",
                                "--worker", trees[label], frames_file, label],
                               cwd=here)
            rc = rc or r.returncode
    finally:
        os.remove(frames_file)
    print(card_line(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
