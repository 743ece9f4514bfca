"""CPU tests of the span readers (`metrics/<name>.py` on `harness/spans.py`)
on hand-made records: the spans of profiled frames are left out, device
time is preferred to host time, `vi_window_ms` skips the windows inside
`mapping.full_vi_ba`, `loop_close_ms` takes only the probes that closed a
loop, each idle share is read on a hand-made trace with known gaps (the
tracking share without the back end that a keyframe frame runs inside
`track`), every reader returns nothing for a program without spans, and
the readers that were there read the same with and without the span log."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from slambench.harness import spans, spec, trace  # noqa: E402
from slambench.harness.records import FrameRecord, RunRecords  # noqa: E402

NEW = ("pose_search_ms", "inertial_solve_ms", "mapper_step_ms", "local_ba_ms",
       "vi_window_ms", "loop_close_ms", "track_device_idle_pct", "mapping_device_idle_pct")
OLD = ("track_frame_ms", "keyframes_per_100", "extract_ms", "stereo_ms", "pose_track_ms",
       "keyframe_frame_ms", "fast_nms_roofline_pct", "launches_per_frame", "device_idle_pct")


def read(name, run):
    return spec.load_reader(name)(run)


class Log:
    """Span records in `export_spans`'s form, made in order."""

    def __init__(self):
        self.recs = []

    def add(self, name, frame, seconds, parent=None, device=True, **counts):
        r = {"id": len(self.recs), "name": name, "frame": frame,
             "parent": None if parent is None else parent["id"],
             "start_ns": 0, "end_ns": 0, "host_s": seconds + 0.5,
             "device_s": seconds if device else None, "counts": counts}
        self.recs.append(r)
        return r


def _frames(n, traced=()):
    return [FrameRecord(index=i, ms=50.0, start=0.05 * i, end=0.05 * (i + 1), kf=i % 4 == 0,
                        loop=False, fail=False, traced=i in traced) for i in range(n)]


def _run(log, n=10, traced=(), tr=None, stages=None):
    stages = dict(stages or {})
    if log is not None:
        stages["spans"] = list(log.recs)
    return RunRecords(frames=_frames(n, traced), window_s=1.0, stages=stages, trace=tr,
                      config={"slam": {"camera": {"height": 400, "width": 640},
                                       "orb": {"n_levels": 8}}})


def test_every_reader_returns_nothing_without_spans():
    run = _run(None)
    for name in NEW:
        assert read(name, run) is None, name


def test_pose_search_sums_a_frame_and_drops_profiled_frames():
    log = Log()
    for f, s in ((0, 0.010), (1, 0.020), (2, 0.030), (3, 0.500)):
        fr = log.add("frame", f, 1.0)
        tk = log.add("track", f, 0.9, fr)
        log.add("track.search", f, s, tk)
    # a fallback's second search adds to its frame
    log.add("track.search", 0, 0.015, tk)
    run = _run(log, traced=(3,))
    # frames 0 (10 + 15 ms), 1 (20), 2 (30); frame 3 was profiled
    assert read("pose_search_ms", run) == pytest.approx(25.0)


def test_host_time_stands_in_without_device_time():
    log = Log()
    for f in range(3):
        log.add("track.inertial_solve", f, 0.1 * (f + 1), device=False)
    # host_s is the device time plus 0.5 s in these records
    assert read("inertial_solve_ms", _run(log)) == pytest.approx(700.0)


def test_mapper_step_and_local_ba_are_per_keyframe():
    log = Log()
    for f, step, ba in ((0, 0.02, 0.08), (4, 0.03, 0.09), (8, 0.04, 0.10), (5, 9.0, 9.0)):
        be = log.add("keyframe.backend", f, 1.0)
        log.add("mapping.mapper_step", f, step, be)
        log.add("mapping.local_ba", f, ba, be)
    run = _run(log, traced=(5,))
    assert read("mapper_step_ms", run) == pytest.approx(30.0)
    assert read("local_ba_ms", run) == pytest.approx(90.0)


def test_vi_window_skips_the_windows_of_the_full_vi_ba():
    log = Log()
    for f, s in ((0, 0.2), (4, 0.4), (8, 0.6)):
        be = log.add("keyframe.backend", f, 2.0)
        log.add("mapping.vi_window", f, s, be)
    be = log.add("keyframe.backend", 9, 30.0)
    full = log.add("mapping.full_vi_ba", 9, 25.0, be)
    for _ in range(2):
        log.add("mapping.vi_window", 9, 10.0, full)
    assert read("vi_window_ms", _run(log)) == pytest.approx(400.0)


def test_loop_close_counts_only_probes_that_closed_a_loop():
    log = Log()
    for f, closed, legs in ((0, 1, (0.1, 0.2, 1.9)), (4, 1, (0.1, 0.3, 2.1)),
                            (6, 0, (0.1,)), (8, 1, (0.2, 0.3, 2.5)), (9, 1, (5.0, 5.0, 5.0))):
        probe = log.add("loop.probe", f, 9.0, closed=closed)
        for name, s in zip(("loop.verify", "loop.correct", "loop.gba"), legs):
            log.add(name, f, s, probe)
    run = _run(log, traced=(9,))
    # closed outside the slice: 2.2, 2.5 and 3.0 s; frame 6 was rejected
    assert read("loop_close_ms", run) == pytest.approx(2500.0)
    assert read("loop_close_ms", _run(log, traced=(0, 4, 8, 9))) is None


def _trace():
    """A slice 0-10 s: device busy 0-3, 5-6 and 9-12; `track` spans 0-4 and
    4.5-6.5 (idle 1 of 4 s, then 1 of 2 s); mapping spans 6.5-9 and a nested
    pair 7-8 and 7.5-8.5 (idle all 2.5 s)."""
    return trace.Trace(
        device=[("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0), ("e", 9.0, 12.0)],
        frames=[(0.0, 4.0), (4.0, 10.0)],
        host=[("orbslam.frame", 0.0, 4.0), ("orbslam.track", 0.0, 4.0),
              ("orbslam.track.search", 0.5, 3.5), ("orbslam.track", 4.5, 6.5),
              ("orbslam.mapping.mapper_step", 6.5, 9.0),
              ("orbslam.mapping.full_vi_ba", 7.0, 8.0),
              ("orbslam.mapping.vi_window", 7.5, 8.5),
              ("orbslam.keyframe.backend", 6.5, 9.5), ("aten::item", 3.0, 5.0)])


def test_idle_shares_inside_the_spans():
    run = _run(None, tr=_trace())
    assert read("track_device_idle_pct", run) == pytest.approx(100.0 * 2.0 / 6.0)
    assert read("mapping_device_idle_pct", run) == pytest.approx(100.0)
    assert read("device_idle_pct", run) == pytest.approx(50.0)


def test_track_idle_leaves_out_the_back_end_inside_it():
    """A keyframe frame: `track` 0-10 s holds the back end 4-8 (its mapper
    step 4.5-7.5); device busy 0-2 and 5-6. Tracking's time is 0-4 and 8-10
    (idle 4 of 6 s), the mapper step's 4.5-7.5 (idle 2 of 3 s)."""
    tr = trace.Trace(device=[("a", 0.0, 2.0), ("b", 5.0, 6.0)], frames=[(0.0, 10.0)],
                     host=[("orbslam.frame", 0.0, 10.0), ("orbslam.track", 0.0, 10.0),
                           ("orbslam.keyframe.backend", 4.0, 8.0),
                           ("orbslam.mapping.mapper_step", 4.5, 7.5)])
    run = _run(None, tr=tr)
    assert read("track_device_idle_pct", run) == pytest.approx(100.0 * 4.0 / 6.0)
    assert read("mapping_device_idle_pct", run) == pytest.approx(100.0 * 2.0 / 3.0)
    # a track span wholly inside the back end leaves no time to read
    tr.host = [("orbslam.frame", 0.0, 10.0), ("orbslam.keyframe.backend", 0.0, 10.0),
               ("orbslam.track", 2.0, 3.0)]
    assert read("track_device_idle_pct", _run(None, tr=tr)) is None


@pytest.mark.parametrize("a, b, want", [
    ([(0.0, 10.0)], [(2.0, 3.0), (5.0, 6.0)], [(0.0, 2.0), (3.0, 5.0), (6.0, 10.0)]),
    ([(0.0, 2.0), (4.0, 6.0)], [(1.0, 5.0)], [(0.0, 1.0), (5.0, 6.0)]),
    ([(1.0, 2.0), (3.0, 4.0)], [(0.0, 5.0)], []),
    ([(1.0, 2.0)], [], [(1.0, 2.0)]),
    ([(0.0, 1.0), (2.0, 3.0)], [(1.0, 2.0), (3.0, 4.0)], [(0.0, 1.0), (2.0, 3.0)]),
])
def test_subtract(a, b, want):
    assert spans._subtract(a, b) == want


def test_idle_shares_read_nothing_without_their_spans():
    tr = _trace()
    tr.host = [h for h in tr.host if not h[0].startswith("orbslam.")]
    run = _run(None, tr=tr)
    assert read("track_device_idle_pct", run) is None
    assert read("mapping_device_idle_pct", run) is None


def test_the_readers_that_were_there_read_the_same_with_spans():
    log = Log()
    for f in range(10):
        fr = log.add("frame", f, 0.1)
        log.add("track.search", f, 0.01 * f, fr)
    stages = {"extract": [0.008, 0.009, 0.007], "stereo_match": [0.005, 0.006],
              "track": [0.06, 0.07, 0.08]}
    tr = _trace()
    tr.launches = 4000
    tr.device.append(("fast_nms_kernel", 6.0, 6.001))
    without = _run(None, traced=(3, 4), tr=tr, stages=stages)
    with_spans = _run(log, traced=(3, 4), tr=tr, stages=stages)
    for name in OLD:
        assert read(name, with_spans) == read(name, without), name
