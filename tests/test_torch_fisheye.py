"""Two-camera Kannala-Brandt stereo in the port against the JAX reference:
`matching.match_fisheye_stereo` on the same features (the inputs of
tests/test_fisheye_stereo.py), with the same gates and u_r / depth to
1e-4, and both trackers end to end on 30 frames of bench.py's room orbit
rendered through a KB8 rig at 320x200 (`cfg.stereo.fisheye`): the same
state and keyframe decision on every frame, camera centres within 1 mm.
The rays' f32 arctan, tan and Newton steps round differently in the two
frameworks, a few ulps, which the 1e-4 tolerance on depth (metres) covers;
u_r (pixels, up to ~600, where an f32 ulp is 6e-5) is held to 1e-4 plus
1e-6 relative."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import CameraConfig as JCam, SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.tracking import matching as jm, tracker as jtr  # noqa: E402
from orbslam3lib_tpu.utils import cameras as jc  # noqa: E402
from orbslam3lib_tpu_torch.config import CameraConfig as TCam, SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.tracking import matching as tmt, tracker as ttr  # noqa: E402

from torch_parity import fast_reference_brief, loop_config, orbit_frames  # noqa: E402,F401
from torch_parity import reference_lie  # noqa: E402,F401

KB8 = np.array([285.0, 285.0, 320.0, 200.0, 0.02, -0.01, 0.003, 0.0], np.float32)
SMALL_KB8_RIG = dict(fx=142.5, fy=142.5, cx=160.0, cy=100.0, width=320, height=200,
                     model="kannala_brandt8", k=(0.02, -0.01, 0.003, 0.0))
N_FRAMES = 30


def _features(seed, case):
    """Left/right KB8 features of random points (the reference test's
    inputs): 'good' shuffles true right projections, 'bad' moves them off
    the epipolar geometry, 'masked' drops a fifth of each side."""
    rng = np.random.default_rng(seed)
    n = 200
    pts = rng.uniform([-2, -1.5, 1.0], [2, 1.5, 4.5], (n, 3)).astype(np.float32)
    t_lr = np.array([0.11, 0, 0], np.float32)
    uv_l = np.asarray(jc.kb8_project(jnp.asarray(KB8), jnp.asarray(pts)))
    uv_r = np.asarray(jc.kb8_project(jnp.asarray(KB8), jnp.asarray(pts - t_lr)))
    desc = rng.integers(0, 2, (n, 256)).astype(np.int8)
    perm = rng.permutation(n)
    vl, vr = np.ones(n, bool), np.ones(n, bool)
    if case == "bad":
        uv_r = uv_l + rng.uniform(-80, 80, uv_l.shape).astype(np.float32)
        perm = np.arange(n)
    if case == "masked":
        vl[rng.permutation(n)[:40]] = False
        vr[rng.permutation(n)[:40]] = False
    # flip a few bits so that the distances straddle the gate
    noisy = desc.copy()
    flips = rng.integers(0, 256, (n, 8))
    for i in range(n):
        noisy[i, flips[i, : i % 9]] ^= 1
    return (uv_l, desc, vl, uv_r[perm], noisy[perm], vr[perm],
            np.eye(3, dtype=np.float32), t_lr)


@pytest.mark.parametrize("case", ["good", "bad", "masked"])
def test_match_fisheye_stereo_agrees(case):
    xl, dl, vl, xr, dr, vr, R, t = _features(11, case)
    bf = 285.0 * 0.11
    ju, jd = jm.match_fisheye_stereo(
        *map(jnp.asarray, (xl, dl, vl, xr, dr, vr)), jnp.asarray(KB8),
        jnp.asarray(KB8), jnp.asarray(R), jnp.asarray(t), bf=bf)
    T = torch.from_numpy
    tu, td = tmt.match_fisheye_stereo(
        *(T(np.array(a)) for a in (xl, dl, vl, xr, dr, vr)), T(KB8), T(KB8), T(R), T(t), bf)
    ju, jd = np.asarray(ju), np.asarray(jd)
    np.testing.assert_array_equal(td.numpy() > 0, jd > 0)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-4)
    # u_r lies at 150-600 px, where one f32 ulp is 1.5e-5 to 6.1e-5 px
    np.testing.assert_allclose(tu.numpy(), ju, rtol=1e-6, atol=1e-4)
    if case == "good":
        assert (jd > 0).sum() > 100


def _kb8_config(cfg_cls, cam_cls, rig):
    cfg = loop_config(cfg_cls, rig)
    cfg.camera = cam_cls(model="kannala_brandt8", fx=rig.fx, fy=rig.fy, cx=rig.cx,
                         cy=rig.cy, k=tuple(rig.k), width=rig.width, height=rig.height)
    cfg.stereo.fisheye = True
    return cfg


@pytest.fixture(scope="module")
def kb8_runs(fast_reference_brief):
    imgs, ts, rig = orbit_frames(N_FRAMES, SMALL_KB8_RIG)
    jt = jtr.Tracker(_kb8_config(JCfg, JCam, rig), "stereo",
                     enable_loop_closing=False, pipeline=0)
    tt = ttr.Tracker(_kb8_config(TCfg, TCam, rig), "stereo", device="cpu",
                     enable_loop_closing=False)
    rec = {"j": [], "t": []}
    for img, stamp in zip(imgs, ts):
        for key, tr in (("j", jt), ("t", tt)):
            res = tr.process_frame(img, float(stamp))
            rec[key].append((res["state"], bool(res.get("kf", False)), tr.stats["n_kf"]))
    return rec, jt, tt


def test_kb8_trackers_agree(kb8_runs):
    rec, jt, tt = kb8_runs
    assert rec["t"] == rec["j"]
    assert tt.state == jt.state == ttr.OK
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 0
    assert tt.stats["n_kf"] >= 2
    np.testing.assert_allclose(tt.trajectory_centers(), jt.trajectory_centers(),
                               rtol=0, atol=1e-3)


def test_kb8_tracker_runs_without_sad_canvas(kb8_runs):
    """The fisheye path skips the SAD refinement (its rows are not
    epipolar lines), in both packages; its landmarks carry the triangulated
    depths."""
    _, jt, tt = kb8_runs
    n = int(jt.map.n_kf)
    np.testing.assert_allclose(tt.map.kf_depth.numpy()[:n], np.asarray(jt.map.kf_depth)[:n],
                               rtol=0, atol=1e-3)
