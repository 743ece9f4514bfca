"""The port's copies of the framework-free reference modules (config, BRIEF
pattern, synthetic renderer, evaluation) equal the originals. They are
copies because importing anything under `orbslam3lib_tpu` imports JAX."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu import config as jcfg, evaluation as jeval  # noqa: E402
from orbslam3lib_tpu.io import synthetic as jsyn  # noqa: E402
from orbslam3lib_tpu.ops.pattern import BIT_PATTERN_31 as J_PATTERN  # noqa: E402
from orbslam3lib_tpu_torch import config as tcfg, evaluation as teval  # noqa: E402
from orbslam3lib_tpu_torch.io import synthetic as tsyn  # noqa: E402
from orbslam3lib_tpu_torch.ops.pattern import BIT_PATTERN_31 as T_PATTERN  # noqa: E402


# the port's own fields, with their defaults: (class name, field) -> default
PORT_ONLY = {("MappingConfig", "mapper_thread"): False}


def _tree(obj, skip=()):
    """(class name, [(field, default or subtree)]) of a config dataclass,
    without the fields `skip` names as (class name, field)."""
    out = []
    for f in dataclasses.fields(obj):
        if (type(obj).__name__, f.name) in skip:
            continue
        v = getattr(obj, f.name)
        out.append((f.name, _tree(v, skip) if dataclasses.is_dataclass(v) else v))
    return type(obj).__name__, out


def test_config_tree_equal():
    """The trees are equal but for the port's own fields, which keep their
    defaults."""
    t = tcfg.SlamConfig()
    assert _tree(t, skip=PORT_ONLY) == _tree(jcfg.SlamConfig())
    for (cls, name), default in PORT_ONLY.items():
        group = next(getattr(t, f.name) for f in dataclasses.fields(t)
                     if type(getattr(t, f.name)).__name__ == cls)
        assert getattr(group, name) == default


@pytest.mark.parametrize("model,dist", [("pinhole", (0.0,) * 5),
                                        ("pinhole", (-0.28, 0.07, 2e-4, 2e-5, 0.0)),
                                        ("kannala_brandt8", (0.0,) * 5)])
def test_config_camera_derived_fields(model, dist):
    j = jcfg.CameraConfig(model=model, dist=dist)
    t = tcfg.CameraConfig(model=model, dist=dist)
    np.testing.assert_array_equal(t.params, j.params)
    assert t.model_id == j.model_id and t.has_dist == j.has_dist


def test_brief_pattern_equal():
    np.testing.assert_array_equal(T_PATTERN, J_PATTERN)


@pytest.mark.parametrize("rig_kw", [
    dict(width=96, height=64, fx=60.0, fy=60.0, cx=48.0, cy=32.0),
    dict(width=96, height=64, fx=60.0, fy=60.0, cx=48.0, cy=32.0,
         dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)),
    dict(width=96, height=64, fx=40.0, fy=40.0, cx=48.0, cy=32.0,
         model="kannala_brandt8", k=(0.01, -0.005, 0.001, 0.0)),
])
def test_synthetic_render_equal(rig_kw):
    """Same world, pose, rig and noise seed -> the same frame. The distorted
    rigs go through the numpy unprojections in place of the reference's jnp
    ones; both are f32 but round differently, and a ray that moves by a
    rounding step moves its texture sample by up to ~0.004 grey levels on
    the steepest octave: held to 0.02 grey levels."""
    R, c, _ = tsyn.orbit_trajectory(3)
    for world_kw in (dict(), dict(half_w=4.0, half_h=1.5, z0=-4.0, z1=4.0, back_wall=True)):
        jt = jsyn.CorridorWorld(**world_kw).render(
            R[2], c[2], jsyn.StereoRig(**rig_kw), rng=np.random.default_rng(1))
        tt = tsyn.CorridorWorld(**world_kw).render(
            R[2], c[2], tsyn.StereoRig(**rig_kw), rng=np.random.default_rng(1))
        if "dist" in rig_kw or "model" in rig_kw:
            np.testing.assert_allclose(tt, jt, rtol=0, atol=0.02)
        else:
            np.testing.assert_array_equal(tt, jt)


def test_orbit_and_ate_equal():
    ts = np.arange(40) / 15.0
    for a, b in zip(tsyn.orbit_pose_at(ts), jsyn.orbit_pose_at(ts)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsyn.orbit_trajectory(10), jsyn.orbit_trajectory(10)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(40, 3))
    est = gt @ np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]) + rng.normal(0, 0.01, (40, 3))
    for scale in (False, True):
        assert teval.ate_rmse(est, gt, scale) == jeval.ate_rmse(est, gt, scale)
