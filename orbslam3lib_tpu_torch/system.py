"""System: the public API facade (port of `orbslam3lib_tpu/system.py`, the
reference's System.cc: TrackStereo, the frame pipeline, Shutdown and the
SaveTrajectory* writers).

    sys_ = System(cfg, SENSOR_STEREO)          # on the card by default
    for pair, ts in frames:
        sys_.track_stereo(pair, ts)
    sys_.save_trajectory_tum("traj.txt")
    sys_.shutdown()

The stereo rigs are the tracker's: rectified pinhole, raw distorted stereo
with `cfg.stereo.rectify` and two-camera Kannala-Brandt stereo with
`cfg.stereo.fisheye`. With `use_pipeline` a bounded producer/consumer
pipeline runs the tracker on a second host thread: a queue of depth 2 that
drops a frame when it is full (System.cc:356-438). The tracker changes
`cfg` on a raw rig (see `Tracker`), so each System takes its own
`SlamConfig`.

Not ported, each raising NotImplementedError with its ROADMAP item: the
mono, RGB-D and inertial sensors, `background_mapping` (the mapper
thread), and `save_atlas` / `load_atlas` (serialization).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .config import SlamConfig
from .evaluation import save_trajectory_kitti, save_trajectory_tum
from .tracking.tracker import LOST, RECENTLY_LOST, Tracker
from .utils.timing import Verbose

SENSOR_MONOCULAR = "mono"
SENSOR_STEREO = "stereo"
SENSOR_RGBD = "rgbd"
SENSOR_IMU_MONOCULAR = "imu_mono"
SENSOR_IMU_STEREO = "imu_stereo"

_UNPORTED_SENSORS = {
    SENSOR_MONOCULAR: "mono (ROADMAP queue 1, item 7: mono)",
    SENSOR_IMU_MONOCULAR: "IMU (ROADMAP queue 1, item 7: IMU)",
    SENSOR_IMU_STEREO: "IMU (ROADMAP queue 1, item 7: IMU)",
    SENSOR_RGBD: "the RGB-D path (ROADMAP queue 1, item 7: RGB-D)",
}


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


class System:
    """The port's public entry point. `device`: where the tracker runs, the
    card unless the caller asks for another (no fallback to the CPU)."""

    def __init__(self, cfg: SlamConfig, sensor: str = SENSOR_STEREO, *,
                 use_pipeline: bool = False, enable_loop_closing: bool = True,
                 enable_timing: bool = False, background_mapping: bool = False,
                 pose_callback: Optional[Callable] = None,
                 device: torch.device | str = "cuda"):
        if sensor in _UNPORTED_SENSORS:
            _unported(f"sensor {sensor!r}: {_UNPORTED_SENSORS[sensor]}")
        if sensor != SENSOR_STEREO:
            raise ValueError(f"unknown sensor {sensor!r}")
        if background_mapping:
            _unported("background_mapping (ROADMAP queue 1, item 7: background_mapping)")
        self.sensor = sensor
        cfg.use_imu = False
        self.tracker = Tracker(cfg, sensor, device=device,
                               enable_loop_closing=enable_loop_closing,
                               enable_timing=enable_timing)
        self.cfg = cfg
        self.pose_callback = pose_callback
        self._shutdown = False
        self._queue: Optional[queue.Queue] = None
        self._consumer: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._dropped = 0
        if use_pipeline:
            self._queue = queue.Queue(maxsize=2)
            self._consumer = threading.Thread(target=self._consume_loop, daemon=True)
            self._consumer.start()

    # -- frame entry points (TrackStereo; the others raise) -------------------
    def track_stereo(self, img_pair: np.ndarray, ts: float, imu=None) -> dict:
        """A stereo pair (2, H, W) at time ts. Returns the tracker's result,
        or {"queued": True} with `use_pipeline`."""
        if imu is not None:
            _unported("IMU input (ROADMAP queue 1, item 7: IMU)")
        return self._dispatch(img_pair, ts)

    def track_monocular(self, img, ts: float, imu=None) -> dict:
        _unported(_UNPORTED_SENSORS[SENSOR_MONOCULAR])

    def track_rgbd(self, img, depth_map, ts: float) -> dict:
        _unported(_UNPORTED_SENSORS[SENSOR_RGBD])

    def _dispatch(self, payload, ts) -> dict:
        if self._queue is None:
            return self._process(payload, ts)
        try:
            self._queue.put_nowait((payload, ts))
        except queue.Full:
            self._dropped += 1
            Verbose.log(f"[system] frame dropped (backpressure), total "
                        f"{self._dropped}", Verbose.VERBOSE)
        return {"queued": True}

    def _consume_loop(self):
        dev = self.tracker.device
        # the consumer thread's current card is the tracker's, set here: a
        # new thread starts on card 0
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            while not self._shutdown:
                try:
                    payload, ts = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                try:
                    out = self._process(payload, ts)
                    if self.pose_callback is not None and self.tracker.pose is not None:
                        R, t = self.tracker.pose
                        self.pose_callback(R.cpu().numpy(), t.cpu().numpy(), ts, out)
                finally:
                    self._queue.task_done()

    def _process(self, payload, ts) -> dict:
        with self._lock:
            return self.tracker.process_frame(payload, ts)

    # -- state (System.h:187-190) ---------------------------------------------
    def get_tracking_state(self) -> int:
        return self.tracker.state

    def get_stats(self) -> dict:
        return dict(self.tracker.stats)

    def is_lost(self) -> bool:
        return self.tracker.state in (RECENTLY_LOST, LOST)

    def map_info(self) -> dict:
        """The live map's keyframe slots in use and landmarks. The port holds
        one map (no Atlas yet): `n_maps` is 1 and `n_new_maps` counts the
        maps given up and dropped after a loss."""
        with self._lock:
            m = self.tracker.map
            return {"n_kf": int(m.n_kf), "n_mp": int(m.n_mp), "n_maps": 1,
                    "n_new_maps": self.tracker.stats["n_new_maps"]}

    # -- lifecycle --------------------------------------------------------------
    def wait_idle(self, timeout: float = 30.0):
        """Wait until the pipeline's queued frames are tracked."""
        if self._queue is None:
            return
        t0 = time.time()
        while self._queue.unfinished_tasks and time.time() - t0 < timeout:
            time.sleep(0.01)

    def shutdown(self):
        """System::Shutdown (System.cc:628): drain the queue and join the
        consumer thread; with timing on, print the stage times."""
        self.wait_idle()
        self._shutdown = True
        if self._consumer is not None:
            self._consumer.join()
            self._consumer = None
        if self.tracker.timer.enabled:
            self.tracker.timer.print_time_stats()

    # -- output (System.h:158-179) ----------------------------------------------
    def save_trajectory_tum(self, path: str):
        traj = self.tracker.trajectory
        save_trajectory_tum(path, [ts for ts, _, _ in traj],
                            [(R, t) for _, R, t in traj])

    def save_trajectory_kitti(self, path: str):
        save_trajectory_kitti(path, [(R, t) for _, R, t in self.tracker.trajectory])

    def save_map_render(self, path: str, title: str = "map"):
        from . import viz
        viz.render_map(path, self.tracker.map, title=title,
                       trajectory=self.tracker.trajectory)

    def export_map_ply(self, path: str):
        from . import viz
        viz.export_ply(path, self.tracker.map, trajectory=self.tracker.trajectory)

    def save_atlas(self, path: str):
        _unported("save_atlas (ROADMAP queue 1, item 7: serialization)")

    def load_atlas(self, path: str):
        _unported("load_atlas (ROADMAP queue 1, item 7: serialization)")

