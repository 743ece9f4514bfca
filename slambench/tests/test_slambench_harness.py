"""CPU tests of the benchmark harness: window arithmetic, the idle share on
a synthetic timeline, kernel 1's byte count, lookup by name, the renderer
against a frozen numpy copy, the orbit's closure and the import check."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from slambench.harness import roofline, spec, trace  # noqa: E402
from slambench.harness.records import FrameRecord, RunRecords  # noqa: E402
from slambench.harness.world import BoxWorld, Rig, orbit_pose_at, pose_at  # noqa: E402


def _frames(ms_list):
    out, t_ms = [], 0.0      # whole milliseconds add up exactly
    for i, ms in enumerate(ms_list):
        out.append(FrameRecord(index=i, ms=ms, start=t_ms / 1e3, end=(t_ms + ms) / 1e3,
                               kf=False, loop=False, fail=False))
        t_ms += ms
    return out


def test_stall_lowers_fps_and_raises_p95():
    steady = RunRecords(frames=_frames([50.0] * 200), window_s=10.0)
    stalled = RunRecords(frames=_frames([50.0] * 180 + [1000.0] + [50.0] * 19), window_s=10.0)
    a, b = steady.end_to_end(1.0), stalled.end_to_end(1.0)
    assert a["fps"] == pytest.approx(20.0)
    assert b["fps"] < a["fps"]                      # the stall's frames never came
    assert b["frame_ms_p50"] == pytest.approx(50.0)
    assert b["frame_ms_p95"] == pytest.approx(a["frame_ms_p95"])  # one in 200 is above p95
    stalled20 = RunRecords(frames=_frames([50.0] * 180 + [1000.0] * 20), window_s=10.0)
    assert stalled20.end_to_end(1.0)["frame_ms_p95"] > 500.0


def test_percentiles_over_all_frames_and_late_frame_not_completed():
    ms = [10.0 * (i + 1) for i in range(20)]          # 10 .. 200 ms, 2.1 s in all
    rec = RunRecords(frames=_frames(ms), window_s=2.0)
    e2e = rec.end_to_end(0.0)
    assert e2e["frame_ms_p50"] == pytest.approx(np.percentile(ms, 50))
    assert e2e["frame_ms_p95"] == pytest.approx(np.percentile(ms, 95))
    assert rec.completed() == 19                      # the last returned after 2 s
    assert e2e["fps"] == pytest.approx(19 / 2.0)


def test_idle_share_on_overlapping_and_gapped_kernels():
    tr = trace.Trace(
        device=[("a", 0.0, 2.0), ("b", 1.0, 3.0),     # overlap: busy 0-3
                ("c", 5.0, 6.0), ("d", 5.5, 5.8),     # nested: busy 5-6
                ("e", 9.0, 12.0)],                     # runs past the window
        frames=[(0.0, 4.0), (4.0, 10.0)],
        host=[("aten::item", 3.0, 5.0), ("cudaStreamSynchronize", 6.2, 8.9)])
    assert trace.busy_seconds(tr) == pytest.approx(3.0 + 1.0 + 1.0)
    assert trace.idle_share(tr) == pytest.approx(0.5)
    assert [round(b - a, 6) for a, b in trace.gaps(tr)] == [3.0, 2.0]
    bd = trace.breakdown(tr)
    assert bd["idle_gaps"][0][0] == "idle in cudaStreamSynchronize"
    assert bd["idle_gaps"][1][0] == "idle in aten::item"
    assert bd["device_ops"][0][0] == "a" and bd["device_ops"][0][1] == pytest.approx(2.0)


def test_fast_nms_bytes_match_the_kernel_table():
    # the kernel table's 10.67 MB per 640x400 stereo frame (8 levels)
    assert roofline.fast_nms_bytes(400, 640, 8, batch=2) == 10_668_576
    assert roofline.fast_nms_bytes(400, 640, 8, batch=1) == 10_668_576 // 2
    assert roofline.bound_seconds(10_668_576) * 1e3 == pytest.approx(0.003185, abs=1e-6)


def test_every_cell_finds_its_files_and_readers():
    bench = spec.benchmark()
    names = [w["name"] for w in bench["workloads"]]
    assert names == ["stereo640_pinhole.orbit", "euroc_vi.corridor"]
    for name in names:
        c = spec.cell(name, bench)
        assert c.config["name"] == c.config_name
        assert c.traffic["name"] == c.traffic_name
        assert c.config["sensor"] in c.traffic["warmup"]
        assert {m.name for m in c.end_to_end} == {"fps", "frame_ms_p50", "frame_ms_p95", "setup_s"}
        assert set(c.readers) == {m.name for m in c.per_layer}
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "limits", f"{name}.json"))
    assert "keyframe_frame_ms" not in spec.cell("stereo640_pinhole.orbit", bench).readers
    assert "keyframe_frame_ms" in spec.cell("euroc_vi.corridor", bench).readers
    with pytest.raises(KeyError):
        spec.cell("no_such.cell", bench)


def _numpy_render(world, R_cw, c_w, rig):
    """A frozen numpy copy of the port's CorridorWorld._trace + render
    (noise free)."""
    H, W = rig.height, rig.width
    d_w = rig.rays() @ R_cw.T
    o = c_w
    img = np.full((H, W), 90.0, np.float32)
    best = np.full((H, W), np.inf, np.float32)
    tables = world.tables.cpu().numpy()
    for axis, val, ti in world.planes:
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (val - o[axis]) / d_w[..., axis]
        hit = (t > 0.05) & np.isfinite(t)
        p = o[None, None, :] + np.where(hit, t, 1.0)[..., None] * d_w
        if axis == 0:
            in_b = (np.abs(p[..., 1]) <= world.half_h) & (p[..., 2] >= world.z0) & \
                (p[..., 2] <= world.z1)
            tu, tv = p[..., 2], p[..., 1]
        elif axis == 1:
            in_b = (np.abs(p[..., 0]) <= world.half_w) & (p[..., 2] >= world.z0) & \
                (p[..., 2] <= world.z1)
            tu, tv = p[..., 0], p[..., 2]
        else:
            in_b = (np.abs(p[..., 0]) <= world.half_w) & (np.abs(p[..., 1]) <= world.half_h)
            tu, tv = p[..., 0], p[..., 1]
        hit &= in_b & (t < best)
        u, v = tu[hit], tv[hit]
        out = np.zeros_like(u, dtype=np.float32)
        amp_sum = 0.0
        for o_ in range(4):
            s = 3.0 * (2.2 ** o_)
            amp = 1.0 / (1.5 ** o_)
            uu, vv = u * s, v * s
            iu, iv = np.floor(uu).astype(np.int64), np.floor(vv).astype(np.int64)
            fu, fv = (uu - iu).astype(np.float32), (vv - iv).astype(np.float32)
            T = tables[ti, o_]
            iu0, iv0 = iu % 256, iv % 256
            val_ = (T[iv0, iu0] * (1 - fu) * (1 - fv) + T[iv0, iu0 + 1] * fu * (1 - fv)
                    + T[iv0 + 1, iu0] * (1 - fu) * fv + T[iv0 + 1, iu0 + 1] * fu * fv)
            out += amp * val_
            amp_sum += amp
        img[hit] = 30.0 + 200.0 * out / amp_sum
        best[hit] = t[hit]
    return img


@pytest.mark.parametrize("traffic,dist", [("orbit", (0.0,) * 5),
                                          ("corridor", (-0.2834, 0.07396, 1.9e-4, 1.8e-5, 0.0))])
def test_torch_renderer_matches_numpy_copy(traffic, dist):
    tr = spec.load_json(os.path.join(spec.BENCH_DIR, "traffic", f"{traffic}.json"))
    world = BoxWorld.from_traffic(tr["world"], torch.device("cpu"))
    rig = Rig(width=96, height=60, fx=60.0, fy=60.0, cx=48.0, cy=30.0, baseline=0.11, dist=dist)
    R, c = pose_at(tr["trajectory"], np.array([0.0, 3.7]))
    R, c = R.astype(np.float32), c.astype(np.float32)
    got = world.render(torch.from_numpy(R), torch.from_numpy(c),
                       torch.from_numpy(rig.rays())).numpy()
    for k in range(2):
        want = _numpy_render(world, R[k], c[k], rig)
        err = np.abs(got[k] - want)
        assert np.mean(err > 0.5) < 0.002, np.mean(err > 0.5)   # texel-edge roundings only
        assert np.median(err) < 1e-3


def test_orbit_closes_after_one_revolution():
    tr = spec.load_json(os.path.join(spec.BENCH_DIR, "traffic", "orbit.json"))["trajectory"]
    t = np.linspace(0.0, 24.0, 97)
    R0, c0 = pose_at(tr, t)
    R1, c1 = pose_at(tr, t + tr["period_s"])
    np.testing.assert_allclose(c1, c0, atol=1e-12)
    np.testing.assert_allclose(R1, R0, atol=1e-12)
    # the port's bob of 3.1 cycles would not close
    _, c_port = orbit_pose_at(np.array([0.0, 24.0]), 24.0, 0.5, 0.08, 3.1)
    assert abs(c_port[1, 1] - c_port[0, 1]) > 1e-2


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from slambench.harness import runner, check, capture, trace\n"
            "import orbslam3lib_tpu_torch.system, orbslam3lib_tpu_torch.tracking.tracker\n"
            "print(runner.forbidden_modules())\n" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from slambench.harness import runner
    monkeypatch.setitem(sys.modules, "orbslam3lib_tpu_torch_fake", object())
    assert "orbslam3lib_tpu_torch_fake" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "orbslam3lib_tpu.fake", object())
    assert "orbslam3lib_tpu.fake" in runner.forbidden_modules()
