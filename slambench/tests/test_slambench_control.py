"""The correctness check's control on the card: in each cell, on one seed
and a short window at the cell's own size, the program's readings are
within the cell's limits and the control (the reference in the program's
place with TF32 products, the window solves from inputs held in bfloat16)
fails at least one of them. Needs a CUDA card;
skips without one. `python3 slambench/control.py` takes the readings on
more seeds."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from slambench import control  # noqa: E402
from slambench.harness import runner, spec  # noqa: E402


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["stereo640_pinhole.orbit", "euroc_vi.corridor"])
def test_control_fails_where_the_program_passes(card, workload):
    cell = spec.cell(workload)
    limits = spec.load_json(os.path.join(spec.BENCH_DIR, "limits", f"{workload}.json"))
    res = runner.execute(cell, runner.Run(seed=2 ** 31 + 99, seconds=10.0, trace=False,
                                          keep=True))
    kept = res.pop("_kept")
    assert res["correct"], res["_lines"]
    ctl = control.control_readings(kept, card)
    assert any(ctl[k] > limits[k] for k in ctl), ctl
