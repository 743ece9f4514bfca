"""Both trackers end to end on a raw radial-tangential stereo rig: the
port's `Tracker(cfg, "stereo", device="cpu")` against the JAX reference's
`Tracker(cfg, "stereo", pipeline=0)` with `cfg.stereo.rectify`, on 20
frames of bench.py's room orbit rendered through bench.py's distortion at
320x200 (`torch_parity.loop_config`, loop closing off). Each rectifies the
raw pair every frame (the port by two gathers, the reference by its shift
loop; test_torch_rectify.py holds the two within an ulp). Checked: the
same configuration after rectification, the same state and keyframe
decision on every frame, camera centres within 1 mm."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.config import SlamConfig as JCfg  # noqa: E402
from orbslam3lib_tpu.tracking import tracker as jtr  # noqa: E402
from orbslam3lib_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from orbslam3lib_tpu_torch.tracking import tracker as ttr  # noqa: E402
from orbslam3lib_tpu_torch.utils import cameras as tc  # noqa: E402

from torch_parity import SMALL_RIG, fast_reference_brief, loop_config, orbit_frames  # noqa: E402,F401
from torch_parity import reference_lie, reference_rectify  # noqa: E402,F401

DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)   # bench.py's
N_FRAMES = 20


def _radtan_config(cfg_cls, rig):
    cfg = loop_config(cfg_cls, rig)
    cfg.camera.dist = DIST
    cfg.camera2 = None
    cfg.stereo.rectify = True
    return cfg


@pytest.fixture(scope="module")
def radtan_runs(fast_reference_brief):
    imgs, ts, rig = orbit_frames(N_FRAMES, dict(SMALL_RIG, dist=DIST))
    jcfg, tcfg = _radtan_config(JCfg, rig), _radtan_config(TCfg, rig)
    jt = jtr.Tracker(jcfg, "stereo", enable_loop_closing=False, pipeline=0)
    tt = ttr.Tracker(tcfg, "stereo", device="cpu", enable_loop_closing=False)
    rec = {"j": [], "t": []}
    for img, stamp in zip(imgs, ts):
        for key, trk in (("j", jt), ("t", tt)):
            res = trk.process_frame(img, float(stamp))
            rec[key].append((res["state"], bool(res.get("kf", False)), trk.stats["n_kf"]))
    return rec, jt, tt, jcfg, tcfg


def test_rectified_config_agrees(radtan_runs):
    """`Tracker.__init__` turns the raw rig into the shared rectified pinhole
    in `cfg` itself, as the reference does."""
    _, _, _, jcfg, tcfg = radtan_runs
    assert tcfg.camera.model_id == tc.PINHOLE and tcfg.camera2 is None
    np.testing.assert_allclose(tcfg.camera.params, jcfg.camera.params, rtol=1e-6)
    assert abs(tcfg.stereo.baseline - jcfg.stereo.baseline) <= 1e-6
    assert tcfg.stereo.R_lr is None and tcfg.stereo.t_lr is None
    np.testing.assert_allclose(tcfg.imu.R_bc, jcfg.imu.R_bc, rtol=0, atol=1e-6)


def test_radtan_trackers_agree(radtan_runs):
    rec, jt, tt, _, _ = radtan_runs
    assert rec["t"] == rec["j"]
    assert tt.state == jt.state == ttr.OK
    assert tt.stats["track_fail"] == jt.stats["track_fail"] == 0
    assert tt.stats["n_kf"] >= 2
    np.testing.assert_allclose(tt.trajectory_centers(), jt.trajectory_centers(),
                               rtol=0, atol=1e-3)
