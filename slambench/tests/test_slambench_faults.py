"""A run of the harness with the timed path broken underneath sees
`correct` come out false, once for each fault a cell can have; a sound run
sees it true. The runs skip the look for a card and drive the port on the
CPU at a small size (the harness's own set-up, window and check), with the
limits of the cell they stand for: the room orbit, and the inertial
corridor after its IMU initialisation."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from slambench.harness import runner, spec  # noqa: E402

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


def small_cell(name: str = "stereo640_pinhole.orbit") -> spec.Cell:
    """The cell at 320x200, 4 levels, 256 keypoints, after 0.5 s of frames
    (no loop asked of the warm-up)."""
    cell = spec.cell(name)
    slam = cell.config["slam"]
    slam["camera"].update({"width": 320, "height": 200, "fx": 150.0, "fy": 150.0,
                           "cx": 160.0, "cy": 100.0})
    slam["orb"].update({"max_kp": 256, "n_levels": 4, "target_features": 200})
    slam.setdefault("tracker", {})["min_init_features"] = 100
    rule = cell.traffic["warmup"][cell.config["sensor"]]
    rule.update({"seconds": 0.5, "require": {"n_kf": 1}})
    cell.traffic["duration_s"] = 6.0
    cell.traffic.pop("replay", None)
    cell.traffic["trace"] = {"skip_frames": 1, "frames": 3}
    return cell


def small_imu_cell() -> spec.Cell:
    """The inertial corridor at the same small size, after 1.5 s of flight
    (the IMU initialised, asked of the warm-up)."""
    cell = small_cell("euroc_vi.corridor")
    cell.traffic["warmup"]["imu_stereo"].update({"seconds": 1.5, "require": {"imu_ready": 1}})
    cell.traffic["duration_s"] = {"imu_stereo": 20.0}
    return cell


def run_small(hooks=(), seconds: float = 8.0, imu: bool = False):
    """One run of the small cell; the window holds at least one keyframe
    (the local BA's, and the VI window's, check needs one)."""
    cell = small_imu_cell() if imu else small_cell()
    limits = spec.load_json(os.path.join(spec.BENCH_DIR, "limits", f"{cell.name}.json"))
    return runner.execute(cell, runner.Run(seed=SEED, seconds=seconds, trace=False,
                                           device="cpu", check_card=False, limits=limits,
                                           hooks=list(hooks)))


def _port():
    from orbslam3lib_tpu_torch.tracking import tracker
    return tracker


def state_unchanged(monkeypatch):
    """Each pose solve returns the pose it was given (its inlier count kept,
    so the tracker goes on as if it had solved)."""
    tr = _port()
    orig = tr.pose_optimization

    def stale(R0, t0, obs, *a, **k):
        _, _, inl, n = orig(R0, t0, obs, *a, **k)
        return R0, t0, inl, n
    return lambda system: monkeypatch.setattr(tr, "pose_optimization", stale)


def half_left_out(monkeypatch):
    """The extractor keeps the first half of each eye's keypoints and drops
    the rest."""
    tr = _port()
    orig = tr.extract_orb_stereo

    def half(img, thr, *a, **k):
        out = orig(img, thr, *a, **k)
        feats = out[0] if isinstance(out, tuple) else out
        n = feats.valid.shape[-1]
        feats.valid = feats.valid & (torch.arange(n) < n // 2)
        return out
    return lambda system: monkeypatch.setattr(tr, "extract_orb_stereo", half)


def answer_altered(monkeypatch):
    """Each pose solve's translation moved by 5 mm where it is produced."""
    tr = _port()
    orig = tr.pose_optimization

    def moved(*a, **k):
        R, t, inl, n = orig(*a, **k)
        return R, t + 0.005, inl, n
    return lambda system: monkeypatch.setattr(tr, "pose_optimization", moved)


def local_ba_unchanged(monkeypatch):
    """Each local BA returns the map it was given, unsolved."""
    tr = _port()
    return lambda system: monkeypatch.setattr(tr, "_local_ba", lambda m, *a, **k: m)


def inertial_unchanged(monkeypatch):
    """Each visual-inertial frame solve returns the state it was given (its
    inlier count and marginal prior kept)."""
    def install(system):
        tracker = system.tracker
        orig = tracker._inertial_refine

        def stale(cur, obs):
            _, n2, H = orig(cur, obs)
            return cur, n2, H
        monkeypatch.setattr(tracker, "_inertial_refine", stale)
    return install


def vi_window_unchanged(monkeypatch):
    """Each VI window returns the poses, velocities and biases it started
    from."""
    tr = _port()
    orig = tr.local_inertial_ba

    def stale(m, window_ids, *a, **k):
        res = orig(m, window_ids, *a, **k)
        ids = torch.clamp(window_ids, 0, m.max_kf - 1).long()
        return res._replace(kf_R=m.kf_R[ids], kf_t=m.kf_t[ids], v=k["v_init"],
                            bg=torch.zeros_like(res.bg) + a[3],
                            ba=torch.zeros_like(res.ba) + a[4])
    return lambda system: monkeypatch.setattr(tr, "local_inertial_ba", stale)


@pytest.mark.parametrize("imu", [False, True], ids=["orbit", "inertial"])
def test_sound_run_is_correct(imu):
    res = run_small(seconds=14.0 if imu else 8.0, imu=imu)
    assert res["correct"], res["_lines"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered,
                                   local_ba_unchanged])
def test_fault_is_not_correct(fault, monkeypatch):
    res = run_small([fault(monkeypatch)])
    assert not res["correct"], res["_lines"]


@pytest.mark.parametrize("fault", [inertial_unchanged, vi_window_unchanged])
def test_inertial_fault_is_not_correct(fault, monkeypatch):
    res = run_small([fault(monkeypatch)], seconds=14.0, imu=True)
    assert not res["correct"], res["_lines"]
