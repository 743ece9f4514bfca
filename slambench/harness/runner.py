"""One run of one cell: set-up (the port, the frames and IMU made from the
seed, the warm-up frames), the measured window, the traced slice, the
correctness check and the result line.

The window is a closed loop with one client: each frame goes to
`System.track_stereo` (with `imu=` the samples since the previous frame on
an inertial rig) when the previous call has returned with the pose on the
host, as ORB-SLAM3's dataset examples do without their sleep.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import spec
from .records import FrameRecord, RunRecords

FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam3lib_tpu")
PORT = "orbslam3lib_tpu_torch"
CACHE_DIR = os.path.join(spec.ROOT, "build", "slambench")


class RunError(RuntimeError):
    """A run that cannot give a result (no card, a warm-up that missed its
    event, frames run out): the message goes to standard error and no
    result is printed."""


def process_start_time() -> float:
    """This process's start on the `time.time()` clock (Linux: from
    /proc/self/stat), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the latter)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def set_cache_dirs() -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE_DIR, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")



@dataclass
class Sequence:
    """The run's inputs: frames (host uint8 stereo pairs) and per-frame IMU
    samples, indexed by sequence frame; `source(i)` maps a frame of the
    sequence to its rendered image (the orbit replays its pool)."""
    frames: np.ndarray
    dt: float
    warmup: int
    n_rendered: int
    cycle_from: Optional[int]
    imu: Optional[list] = None
    traffic_path: str = ""

    def source(self, i: int) -> int:
        if i < self.n_rendered:
            return i
        if self.cycle_from is None:
            raise RunError(f"the frames of {self.traffic_path} ran out at frame {i}: "
                           "lengthen its sequence (duration_s, and z1 of its world)")
        span = self.n_rendered - self.cycle_from
        return self.cycle_from + (i - self.cycle_from) % span

    def pair(self, i: int) -> np.ndarray:
        return self.frames[self.source(i)]

    def imu_of(self, i: int):
        """The samples since frame i - 1 (a cycled frame takes its source's:
        the motion repeats with the trajectory)."""
        if self.imu is None or i == 0:
            return None
        return self.imu[self.source(i)]


def make_sequence(cell: spec.Cell, seed: int, device) -> Sequence:
    """Frames of the cell's traffic for its configuration, rendered on the
    card with noise from `seed`; with an IMU, its samples (numpy, from
    `seed`). Replay rule: `replay.cycle_from_s` names the sequence time
    from which a window that outruns the rendered frames cycles back (the
    trajectory must close on itself over that span); without it the
    frames must suffice."""
    import torch
    from . import imu as imu_gen
    from .world import BoxWorld, Rig, pose_at, render_stereo
    cfg, tr = cell.config, cell.traffic
    fps = float(cfg["fps"])
    dt = 1.0 / fps
    warm = warmup_rule(cell)
    n_warm = int(round(float(warm["seconds"]) * fps))
    dur = tr["duration_s"]
    if isinstance(dur, dict):
        if cfg["sensor"] not in dur:
            raise RunError(f"{cell.traffic_path} has no duration for sensor {cfg['sensor']!r}")
        dur = dur[cfg["sensor"]]
    n = int(round(float(dur) * fps))
    cyc = tr.get("replay", {}).get("cycle_from_s")
    ts = np.arange(n, dtype=np.float64) * dt
    R_cw, c_w = pose_at(tr["trajectory"], ts)
    world = BoxWorld.from_traffic(tr["world"], device)
    slam = cfg["slam"]
    rig = Rig.from_config(slam["camera"], slam["stereo"]["baseline"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    frames = render_stereo(world, rig, R_cw, c_w, float(cfg["image_noise_sigma"]), gen)
    seq = Sequence(frames=frames, dt=dt, warmup=n_warm, n_rendered=n,
                   cycle_from=None if cyc is None else int(round(float(cyc) * fps)),
                   traffic_path=os.path.relpath(cell.traffic_path, spec.ROOT))
    if cfg.get("imu") is not None:
        ic = cfg["imu"]
        freq = float(slam["imu"]["freq"])
        its, gyro, acc = imu_gen.imu_samples(
            tr["trajectory"], ts[-1], freq, float(slam["imu"]["noise_gyro"]),
            float(slam["imu"]["noise_acc"]), ic["bias_gyro"], ic["bias_acc"],
            int(seed) % (2 ** 63))
        seq.imu = imu_gen.per_frame(ts, its, gyro, acc, freq)
    return seq


def warmup_rule(cell: spec.Cell) -> dict:
    """The traffic's warm-up rule for the configuration's sensor."""
    rules = cell.traffic["warmup"]
    sensor = cell.config["sensor"]
    if sensor not in rules:
        raise RunError(f"{cell.traffic_path} has no warm-up rule for sensor {sensor!r}")
    return rules[sensor]


def slam_config(cell: spec.Cell):
    """The port's SlamConfig with the configuration file's `slam` values."""
    from orbslam3lib_tpu_torch.config import SlamConfig
    cfg = SlamConfig()
    for group, values in cell.config["slam"].items():
        target = getattr(cfg, group)
        for k, v in values.items():
            if not hasattr(target, k):
                raise KeyError(f"{cell.config_path}: slam.{group} has no field {k!r}")
            setattr(target, k, tuple(v) if isinstance(v, list) else v)
    return cfg


def warm_events(tracker) -> Dict[str, float]:
    """The events a warm-up rule may require, read from the tracker."""
    st = tracker.stats
    return {"n_kf": st["n_kf"], "n_loops": st["n_loops"], "imu_ready": float(tracker.imu_ready),
            "viba_stage": float(tracker._viba_stage), "track_fail": st["track_fail"]}


@dataclass
class Run:
    """What a run needs besides its cell; the tests swap `device` and
    `check_card` to drive a run on the CPU."""
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    check_card: bool = True
    out_dir: Optional[str] = None
    limits: Optional[Dict[str, float]] = None
    hooks: list = field(default_factory=list)   # callables(system) run before the window
    keep: bool = False      # return the captures and the sequence (the control)


def _frame_call(system, seq: Sequence, i: int):
    imu = seq.imu_of(i)
    ts = i * seq.dt
    if imu is None:
        return system.track_stereo(seq.pair(i), ts)
    return system.track_stereo(seq.pair(i), ts, imu=imu)


def execute(cell: spec.Cell, run: Run) -> dict:
    """Set-up, window, trace, check; returns the result object (the last
    line's keys) and, under `_lines`, the check's lines for standard error."""
    t_proc = process_start_time()
    set_cache_dirs()
    import torch
    if run.check_card:
        if not torch.cuda.is_available():
            raise RunError("no CUDA card: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"the cell asks for {cell.chips} cards, "
                           f"{torch.cuda.device_count()} are visible")
    try:
        from orbslam3lib_tpu_torch.system import System
        from orbslam3lib_tpu_torch.tracking import matching as port_matching
        from orbslam3lib_tpu_torch.tracking import tracker as port_tracker
    except ImportError as e:
        raise RunError(f"the port {PORT} cannot be imported: {e}") from e
    from . import check
    from .capture import Recorder, Reservoir
    dev = torch.device(run.device)
    limits = run.limits if run.limits is not None else spec.load_json(
        os.path.join(spec.BENCH_DIR, "limits", f"{cell.name}.json"))

    t_render, wall_render = time.perf_counter(), time.time()
    seq = make_sequence(cell, run.seed, dev)
    t_warm = time.perf_counter()
    system = System(slam_config(cell), cell.config["sensor"], enable_timing=run.trace,
                    enable_loop_closing=True, device=dev)
    tracker = system.tracker
    events_at: Dict[str, int] = {}      # the warm-up frame at which each event first read
    for i in range(seq.warmup):
        _frame_call(system, seq, i)
        for k, v in warm_events(tracker).items():
            if v > 0 and k not in events_at:
                events_at[k] = i
    need = warmup_rule(cell).get("require", {})
    got = warm_events(tracker)
    missed = {k: (got.get(k), v) for k, v in need.items() if not got.get(k, -math.inf) >= v}
    if missed:
        raise RunError(f"warm-up of {seq.warmup} frames ({cell.traffic_path}) missed its "
                       f"events (read, required): {missed}")
    if run.trace and dev.type == "cuda":
        _warm_profiler(torch, dev)
    for hook in run.hooks:
        hook(system)
    phases = {"start_to_render_s": wall_render - t_proc,
              "render_s": t_warm - t_render, "warmup_s": time.perf_counter() - t_warm,
              "warmup_frames": seq.warmup, "rendered_frames": seq.n_rendered,
              "warmup_events_at": events_at}

    rng = np.random.default_rng(int(run.seed) % (2 ** 63))
    sample = Reservoir(rng, int(cell.traffic["check"]["frames"]))
    rec = Recorder(port_tracker, port_matching, tracker, run.seed,
                   int(cell.traffic["check"]["backend_solves"])).install()
    tr_cfg = cell.traffic["trace"]
    trace_lo = seq.warmup + int(tr_cfg["skip_frames"])
    trace_hi = trace_lo + int(tr_cfg["frames"])
    prof = stopped = None     # the profiler while it records, then once stopped
    stats0 = dict(tracker.stats)
    tracker.timer.samples.clear()
    frames: List[FrameRecord] = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_win = time.perf_counter()
    setup_s = time.time() - t_proc
    t_end = t_win + run.seconds
    i = seq.warmup
    try:
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            if run.trace and i == trace_lo:
                prof = _start_profiler(torch)
            if sample.offer(i) is not None:
                rec.begin(i)
            st = tracker.stats
            kf0, lp0, fail0 = st["n_kf"], st["n_loops"], st["track_fail"]
            if prof is not None:
                with torch.profiler.record_function("slambench.frame"):
                    _frame_call(system, seq, i)
            else:
                _frame_call(system, seq, i)
            t1 = time.perf_counter()
            rec.end()
            pose_ok = bool(tracker.trajectory) and tracker.trajectory[-1][0] == i * seq.dt \
                and np.isfinite(tracker.trajectory[-1][1]).all() \
                and np.isfinite(tracker.trajectory[-1][2]).all()
            frames.append(FrameRecord(
                index=i, ms=(t1 - t0) * 1e3, start=t0 - t_win, end=t1 - t_win,
                kf=st["n_kf"] > kf0, loop=st["n_loops"] > lp0,
                fail=st["track_fail"] > fail0 or not pose_ok,
                traced=prof is not None))
            i += 1
            if prof is not None and i == trace_hi:
                prof.stop()
                prof, stopped = None, prof
    finally:
        rec.uninstall()
    if prof is not None:
        prof.stop()
        stopped = prof
    # the events are read after the window, outside the frames' time
    trace_read = _read_trace(stopped) if stopped is not None else None
    stages = {k: list(v) for k, v in tracker.timer.samples.items()}
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    t_first = seq.warmup * seq.dt - 1e-9
    window_entries = [e for e in tracker.trajectory if e[0] >= t_first]
    m = tracker.map
    kf_arrays = tuple(x.cpu().numpy() for x in (m.kf_valid, m.kf_R, m.kf_t, m.kf_ts))
    ts_origin = tracker._ts_origin
    stats_delta = {k: v - stats0.get(k, 0) for k, v in tracker.stats.items()
                   if isinstance(v, (int, float))}
    tracker.timer.enabled = False      # shutdown would print its table on stdout
    system.shutdown()
    del system, tracker, m
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    # -- correctness, after the window, the peak read and the state freed --
    chosen = set(sample.chosen)
    caps = [c for c in rec.frames if c.index in chosen]
    reported = {"ate_m": check.trajectory_ate(window_entries, cell.traffic["trajectory"]),
                "kf_ate_m": check.keyframe_ate(*kf_arrays, ts_origin, t_first,
                                               cell.traffic["trajectory"])}
    numbers = {}
    fe = check.FrontEnd(cell.config, dev)
    numbers["frontend_mismatch"] = float(check.frontend_mismatch(caps, seq.pair, fe))
    numbers["pose_gap"] = check.pose_gap(caps)
    backend = {k: list(r.chosen) for k, r in rec.backend.items()}
    numbers["local_ba_gap"] = check.local_ba_gap(backend["local_ba"], device=dev)
    if seq.imu is not None:
        numbers["preint_gap"] = check.preint_gap(caps, seq.imu_of)
        numbers["inertial_gap"] = check.inertial_gap(caps, device=dev)
        numbers["vi_window_gap"] = check.vi_window_gap(backend["vi_window"], device=dev)
    correct = check.judge(numbers, limits)

    records = RunRecords(frames=frames, window_s=run.seconds, stages=stages,
                         stats_delta=stats_delta, trace=trace_read,
                         config=cell.config)
    metrics = _metrics(cell, run, records, setup_s)
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package were loaded: {found}")
    result = {
        "correct": bool(correct),
        "attempted": len(frames),
        "failed": sum(1 for f in frames if f.fail),
        "metrics": metrics,
        "device": _device(torch, dev, cell.chips, peak, records, run.trace),
    }
    if run.trace and records.trace is not None:
        from .trace import breakdown
        result["breakdown"] = breakdown(records.trace)
    result["reported"] = {k: _finite(v) for k, v in reported.items()}
    result["checks"] = {k: {"value": _finite(numbers.get(k)), "limit": v}
                        for k, v in limits.items()}      # the line's last key
    if run.out_dir:
        _write_log(run, cell, frames, {**numbers, **reported}, stats_delta, phases,
                   records.trace)
    print(f"slambench: set-up {phases}", file=sys.stderr)
    result["_lines"] = [f"{k} {v!r} (reported, not judged)" for k, v in reported.items()] \
        + check.lines(numbers, limits)
    if run.keep:
        result["_kept"] = {"caps": caps, "seq": seq, "frontend": fe, "backend": backend,
                           "numbers": {**numbers, **reported}}
    return result


def _finite(x):
    """A number for the JSON line: None where it is missing or not finite
    (a check that could not be made, which fails its limit)."""
    return x if x is not None and math.isfinite(x) else None


def _warm_profiler(torch, dev) -> None:
    """Start and stop the profiler once in set-up: its first start sets up
    the device tracing, which takes seconds and would otherwise fall in the
    window."""
    prof = _start_profiler(torch)
    torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize(dev)
    prof.stop()


def _start_profiler(torch):
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _read_trace(prof):
    from .trace import from_profiler
    return from_profiler(prof)


def _metrics(cell: spec.Cell, run: Run, rec: RunRecords, setup_s: float) -> dict:
    if not run.trace:
        values = rec.end_to_end(setup_s)
        return {m.name: {"value": values[m.name], "unit": m.unit} for m in cell.end_to_end}
    out = {}
    for m in cell.per_layer:
        v = cell.readers[m.name](rec)
        if v is not None:
            out[m.name] = {"value": v, "unit": m.unit}
    return out


def _device(torch, dev, chips: int, peak: int, rec: RunRecords, traced: bool) -> dict:
    d = {"platform": "gpu" if dev.type == "cuda" else dev.type,
         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
         "count": chips, "memory_peak_bytes": peak}
    if traced and rec.trace is not None:
        from .trace import busy_seconds
        w0, w1 = rec.trace.window
        d["busy_s"] = busy_seconds(rec.trace)
        d["window_s"] = w1 - w0
    return d


def _write_log(run: Run, cell: spec.Cell, frames, numbers, stats_delta, phases,
               tr) -> None:
    os.makedirs(run.out_dir, exist_ok=True)
    path = os.path.join(run.out_dir, f"{cell.name}.seed{run.seed}.trace{int(run.trace)}"
                                     ".frames.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"workload": cell.name, "seed": run.seed, "seconds": run.seconds,
                            "checks": numbers, "stats_delta": stats_delta,
                            "setup_phases": phases}) + "\n")
        if tr is not None:
            from .trace import device_totals
            f.write(json.dumps({"device_totals": device_totals(tr),
                                "slice_frames": len(tr.frames)}) + "\n")
        for fr in frames:
            f.write(json.dumps(fr.__dict__) + "\n")
