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
drops a frame when it is full (System.cc:356-438). With
`background_mapping` the tracker's mapper thread runs each keyframe's
LocalMapping and LoopClosing (and `cfg.mapping.async_gba` the global BA on
a thread of its own); `shutdown` waits for their work and joins every
thread. The tracker changes `cfg` on a raw rig (see `Tracker`), so each
System takes its own `SlamConfig`.

Monocular (`System(cfg, SENSOR_MONOCULAR).track_monocular(img, ts)`):
two-view initialisation, then the tracker without depth; a loop is closed
with a free-scale Sim(3). RGB-D (`System(cfg, SENSOR_RGBD).track_rgbd(img,
depth_map, ts)`): one extraction per frame, the depth map read at the
keypoints on the card, then the stereo tracker on virtual right
coordinates. Every sensor goes through the tracker's own per-frame
preamble (timestamp guards, compaction, the map lock); the reference's
RGB-D path bypasses it (`_process_rgbd`, ROADMAP queue 3).

The tracker's maps live in an Atlas: a lost map is archived and merged back
on a revisit. `save_atlas` / `load_atlas` write and read it as the
reference's npz file (`models/serialization.py`), so a file written by
either package loads in the other.

Inertial (`System(cfg, SENSOR_IMU_STEREO).track_stereo(pair, ts,
imu=(gyro, acc, dts))`, and `SENSOR_IMU_MONOCULAR` with `track_monocular`;
reference system.py:34-46, :105-109): the stereo or monocular tracker with
`cfg.use_imu` set; each frame's IMU samples since the previous frame are fed
to the tracker (`Tracker.feed_imu`) right before the frame, on the consumer
thread too with `use_pipeline`.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .config import SlamConfig
from .evaluation import save_trajectory_kitti, save_trajectory_tum
from .device import on_device, to_host
from .models.serialization import load_atlas, save_atlas
from .tracking.tracker import LOST, RECENTLY_LOST, SENSORS, Tracker
from .utils.timing import Verbose

SENSOR_MONOCULAR = "mono"
SENSOR_STEREO = "stereo"
SENSOR_RGBD = "rgbd"
SENSOR_IMU_MONOCULAR = "imu_mono"
SENSOR_IMU_STEREO = "imu_stereo"

# each sensor's tracker sensor and whether it carries an IMU
_SENSORS = {SENSOR_STEREO: ("stereo", False), SENSOR_MONOCULAR: ("mono", False),
            SENSOR_RGBD: ("rgbd", False), SENSOR_IMU_STEREO: ("stereo", True),
            SENSOR_IMU_MONOCULAR: ("mono", True)}
assert {b for b, _ in _SENSORS.values()} == set(SENSORS)


class System:
    """The port's public entry point. `device`: where the tracker runs, the
    card unless the caller asks for another (no fallback to the CPU)."""

    def __init__(self, cfg: SlamConfig, sensor: str = SENSOR_STEREO, *,
                 use_pipeline: bool = False, enable_loop_closing: bool = True,
                 enable_timing: bool = False, background_mapping: bool = False,
                 pose_callback: Optional[Callable] = None,
                 device: torch.device | str = "cuda"):
        if sensor not in _SENSORS:
            raise ValueError(f"unknown sensor {sensor!r}")
        self.sensor = sensor
        base, cfg.use_imu = _SENSORS[sensor]
        self.tracker = Tracker(cfg, base, device=device,
                               enable_loop_closing=enable_loop_closing,
                               enable_timing=enable_timing,
                               async_mapping=background_mapping)
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

    # -- frame entry points (TrackStereo / TrackMonocular / TrackRGBD) ---------
    def track_stereo(self, img_pair: np.ndarray, ts: float, imu=None) -> dict:
        """A stereo pair (2, H, W) at time ts; on `imu_stereo`, `imu` the
        (gyro (N, 3), acc (N, 3), dts (N,)) samples since the previous
        frame. Returns the tracker's result, or {"queued": True} with
        `use_pipeline`."""
        self._check_entry("stereo", imu)
        return self._dispatch((img_pair, None), ts, imu)

    def track_monocular(self, img, ts: float, imu=None) -> dict:
        """One (H, W) image at time ts; as `track_stereo` (`imu` on
        `imu_mono`)."""
        self._check_entry("mono", imu)
        return self._dispatch((img, None), ts, imu)

    def track_rgbd(self, img, depth_map, ts: float) -> dict:
        """One (H, W) image and its (H, W) depth map (0 where there is no
        depth) at time ts; as `track_stereo`."""
        self._check_entry("rgbd", None)
        return self._dispatch((img, depth_map), ts, None)

    def _check_entry(self, base: str, imu) -> None:
        mine, inertial = _SENSORS[self.sensor]
        if base != mine:
            raise ValueError(f"a {base} frame given to a {self.sensor!r} System")
        if imu is not None and not inertial:
            raise ValueError(f"IMU samples given to a {self.sensor!r} System")

    def _dispatch(self, payload, ts, imu) -> dict:
        if self._queue is None:
            return self._process(payload, ts, imu)
        try:
            self._queue.put_nowait((payload, ts, imu))
        except queue.Full:
            self._dropped += 1
            Verbose.log(f"[system] frame dropped (backpressure), total "
                        f"{self._dropped}", Verbose.VERBOSE)
        return {"queued": True}

    def _consume_loop(self):
        with on_device(self.tracker.device):
            while not self._shutdown:
                try:
                    payload, ts, imu = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                try:
                    out = self._process(payload, ts, imu)
                    if self.pose_callback is not None and self.tracker.pose is not None:
                        R, t = self.tracker.pose
                        self.pose_callback(to_host(R), to_host(t), ts, out)
                finally:
                    self._queue.task_done()

    def _process(self, payload, ts, imu) -> dict:
        img, depth_map = payload
        with self._lock:
            if imu is not None:
                self.tracker.feed_imu(*imu)
            return self.tracker.process_frame(img, ts, depth_map=depth_map)

    # -- state (System.h:187-190) ---------------------------------------------
    def get_tracking_state(self) -> int:
        return self.tracker.state

    def get_stats(self) -> dict:
        return dict(self.tracker.stats)

    def is_lost(self) -> bool:
        return self.tracker.state in (RECENTLY_LOST, LOST)

    def map_info(self) -> dict:
        """The current map's keyframe slots in use and landmarks, and the
        number of maps in the Atlas (read under the map lock: the mapper
        thread inserts keyframes and merges maps under it)."""
        with self._lock, self.tracker._map_lock:
            m = self.tracker.map
            return {"n_kf": int(m.n_kf), "n_mp": int(m.n_mp),
                    "n_maps": self.tracker.atlas.count_maps()}

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
        consumer thread, flush the tracker, wait for the mapper's queue and
        a running global BA, and join their threads; with timing on, print
        the stage times."""
        self.wait_idle()
        self._shutdown = True
        if self._consumer is not None:
            self._consumer.join()
            self._consumer = None
        with self._lock:
            self.tracker.finish()
            self.tracker.shutdown_mapping()
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

    # -- checkpoint / resume (System.cc:146-150, disabled in ORB-SLAM3's
    #    release; the reference's system.py:203-209) ---------------------------
    def save_atlas(self, path: str):
        """Every map of the Atlas to an npz file (the reference's keys),
        written under the map lock, so the file holds the Atlas between two
        of the mapper thread's keyframes, never in the middle of one."""
        with self._lock, self.tracker._map_lock:
            save_atlas(self.tracker.atlas, path)

    def load_atlas(self, path: str):
        """Continue from the maps of an npz atlas file, on the tracker's
        device (`Tracker.load_atlas`: the loaded maps can merge with the
        run's new map)."""
        with self._lock:
            self.tracker.load_atlas(load_atlas(path, device=self.tracker.device))

