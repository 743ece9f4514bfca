#!/usr/bin/env python3
"""Trace chip_smoke.py's phase P populate on the card: the keyframe
decision of every consumed frame, over several runs in one process, and
where the runs first part.

    python3 tools/trace_populate.py [--runs 3] [--out FILE]

The populate is phase P's (bench.py's full_slam protocol, bench.py:329-440):
`Tracker(cfg, "stereo", pipeline=16, chunk=4, async_mapping=True)` with
`cfg.mapping.async_gba`, the mapper queue detached (mapping inline), a
keyframe every 2nd frame and culling off, over the first N_POPULATE frames
of the bench orbit. For every frame the pipelined consumer reads
(`Tracker._consume_record`) it logs the pack's inliers, close tracked and
untracked counts, the frame's pose, the reference keyframe's match count,
the frames since the last keyframe, whether the mapper was idle and the
decision; besides, each compaction, loss and landmark-pressure read. Runs
after the first repeat the populate on fresh trackers; the last one with
`torch.use_deterministic_algorithms(True, warn_only=True)`, which records
every operation of the port that has no deterministic CUDA form (the call
site inside the package) and runs the others' deterministic forms.

Prints per run the keyframes made, the landmarks and the compactions; for
each pair of runs the first frame whose pose differs by more than 1e-6 and
the first decision (or its inputs) that differs; and the nondeterministic
call sites. Writes every run's records to --out (JSON) when given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

N_POPULATE = 240


def populate(imgs, ts, rig, dev, record_nondet: bool):
    """One populate; returns (per-frame records, events, summary, sites)."""
    from orbslam3lib_tpu_torch.io.synthetic import orbit_tracking_config
    from orbslam3lib_tpu_torch.tracking.tracker import Tracker
    cfg = orbit_tracking_config(rig)
    cfg.mapping.async_gba = True
    tr = Tracker(cfg, "stereo", device=dev, pipeline=16, chunk=4, async_mapping=True)
    recs, events = [], []
    consume, compact, decide = tr._consume_record, tr._compact_map, tr._need_new_keyframe_scalars
    probe = tr._probe_mp_pressure
    pending = {}

    def decide_logged(n_inl, n_t, n_u, fid):
        out = decide(n_inl, n_t, n_u, fid)
        pending.update(n_inl=int(n_inl), close_tracked=int(n_t), close_untracked=int(n_u),
                       ref_kf_matches=int(tr.ref_kf_matches),
                       frames_since=int(fid - tr.last_kf_frame),
                       mapper_idle=tr._map_queue is None or tr._map_queue.unfinished_tasks == 0,
                       kf=bool(out))
        return out

    def consume_logged(rec, c, v, prev_pose):
        pending.clear()
        ok = consume(rec, c, v, prev_pose)
        recs.append(dict(fid=int(rec.fids[c]), ok=bool(ok),
                         pose=[float(x) for x in v[4:16]], **pending))
        return ok

    def compact_logged():
        done = compact()
        events.append(("compaction", tr.frame_id, bool(done), int(tr.map.n_mp)))
        return done

    def probe_logged():
        probe()
        events.append(("mp pressure read", tr.frame_id, bool(tr._mp_pressure)))

    tr._consume_record, tr._compact_map = consume_logged, compact_logged
    tr._need_new_keyframe_scalars, tr._probe_mp_pressure = decide_logged, probe_logged
    cfg.tracker.kf_ref_ratio = 10.0
    cfg.tracker.min_frames_between_kf = 2
    cfg.tracker.max_frames_between_kf = 2
    cfg.mapping.kf_culling = False
    tr._map_queue_saved, tr._map_queue = tr._map_queue, None
    sites = {}
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if record_nondet:
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for i in range(N_POPULATE):
                n = len(caught)
                tr.process_frame(imgs[i], float(ts[i]))
                for w in caught[n:]:
                    if "deterministic" in str(w.message):
                        site = f"{w.filename}:{w.lineno}: {str(w.message)[:120]}"
                        sites[site] = sites.get(site, 0) + 1
            tr.finish()
        finally:
            if record_nondet:
                torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    summary = dict(n_kf=int(tr.map.n_kf), n_mp_live=int(tr.map.mp_valid.sum()),
                   n_mp=int(tr.map.n_mp), track_fail=tr.stats["track_fail"],
                   compactions=tr.stats["n_compactions"],
                   frames_skipped=tr.stats["frames_skipped"],
                   seconds=round(time.perf_counter() - t0, 1))
    tr._map_queue = tr._map_queue_saved
    tr.shutdown_mapping()
    return recs, events, summary, sites


def first_difference(a, b):
    """(first frame whose pose differs by more than 1e-6, first record whose
    decision or its inputs differ), each as (index, record a, record b)."""
    pose = dec = None
    for i, (x, y) in enumerate(zip(a, b)):
        if pose is None and (x["fid"] != y["fid"] or
                             np.abs(np.subtract(x["pose"], y["pose"])).max() > 1e-6):
            pose = (i, x, y)
        keys = ("fid", "n_inl", "close_tracked", "close_untracked", "ref_kf_matches",
                "frames_since", "kf", "ok")
        if dec is None and any(x.get(k) != y.get(k) for k in keys):
            dec = (i, x, y)
        if pose is not None and dec is not None:
            break
    return pose, dec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", help="JSON file for every run's records")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("[trace] needs a CUDA card", flush=True)
        return 2
    from orbslam3lib_tpu_torch.device import card_line
    from orbslam3lib_tpu_torch.io.synthetic import StereoRig, render_orbit_sequence
    print(f"[trace] {card_line()}", flush=True)
    t0 = time.perf_counter()
    imgs, ts, rig = render_orbit_sequence(N_POPULATE, StereoRig())
    print(f"[trace] rendered {N_POPULATE} frames in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda:0")
    runs = []
    for r in range(args.runs):
        nondet = r == args.runs - 1 and args.runs > 2
        try:
            recs, events, summary, sites = populate(imgs, ts, rig, dev, nondet)
        except Exception:
            traceback.print_exc()
            return 1
        runs.append(dict(records=recs, events=events, summary=summary, sites=sites,
                         deterministic_mode=nondet))
        print(f"[trace] run {r}{' (deterministic algorithms, warn only)' if nondet else ''}: "
              f"{summary}; events {[e for e in events if e[0] != 'mp pressure read']}; "
              f"pressure reads {[e[2] for e in events if e[0] == 'mp pressure read']}",
              flush=True)
    for i in range(len(runs)):
        for j in range(i + 1, len(runs)):
            pose, dec = first_difference(runs[i]["records"], runs[j]["records"])
            print(f"[trace] runs {i} and {j}: first pose difference "
                  f"{None if pose is None else (pose[0], pose[1]['fid'])}; first decision "
                  f"difference {dec}", flush=True)
    sites = runs[-1]["sites"]
    print(f"[trace] nondeterministic operations on the populate path "
          f"({len(sites)} call sites): " + json.dumps(sites, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
