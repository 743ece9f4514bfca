"""The port imports neither JAX nor the JAX package: every module of
`orbslam3lib_tpu_torch` imports in a fresh interpreter where both are
blocked (`sys.modules[name] = None` makes any import of them fail), as on
the machine with the card, which has no JAX."""
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import orbslam3lib_tpu_torch as pkg
    names = ["orbslam3lib_tpu_torch"]
    for info in pkgutil.walk_packages(pkg.__path__, prefix="orbslam3lib_tpu_torch."):
        names.append(info.name)
    return names


def test_port_module_list_covers_the_slice():
    names = set(_port_modules())
    for mod in ("ops.cuda_fast", "ops.cuda_matcher", "ops.extractor",
                "tracking.tracker", "tracking.reloc", "models.map_state",
                "io.synthetic", "evaluation", "config", "device",
                "mapping.local_ba", "mapping.local_mapping", "mapping.loop_closing",
                "mapping.map_ba", "models.vocabulary", "utils.smallmat",
                "mapping.sim3", "mapping.pose_graph", "utils.lie",
                "utils.sampling", "utils.cameras", "utils.rectify",
                "utils.timing", "tracking.matching", "viz", "system",
                "models.atlas", "models.serialization", "mapping.twoview"):
        assert f"orbslam3lib_tpu_torch.{mod}" in names


@pytest.mark.parametrize("block", [("jax", "orbslam3lib_tpu")])
def test_port_imports_without_jax(block):
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{b!r}] = None\n" for b in block)
        + "pre = set(sys.modules)\n"
        + "import importlib\n"
        + f"for name in {_port_modules()!r}:\n"
        + "    importlib.import_module(name)\n"
        + "bad = sorted(m for m in set(sys.modules) - pre if m.split('.')[0] in "
        + f"{list(block)!r})\n"
        + "assert not bad, bad\n"
        + "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
