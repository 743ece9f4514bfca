"""The tests' fast build of the JAX reference's fused blur+compare BRIEF
table (`torch_parity.reference_compare_blur_matrices`, two matmuls) equals
the reference's own einsum on every one of the 64 angle bins.

The extractor, tracking and slice parity tests build the reference's table
that way, because the einsum over the whole table costs over a minute per
process. The shortcut is the formula the port uses too, so it must be held
to the reference's code, not to the port: here every bin's rows go through
the reference's einsum, eight bins per case (about ten seconds each).
A compare row has at most two non-zeros, so the einsum of one bin's rows
gives the same values as the reference's einsum over the whole table."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orbslam3lib_tpu.ops import orient_brief as job  # noqa: E402

from torch_parity import reference_compare_blur_matrices  # noqa: E402

BINS_PER_CASE = 8


@pytest.fixture(scope="module")
def tables():
    D = job._compare_matrices().astype(np.float64)
    B = job._blur_matrix().astype(np.float64)
    return D, B, reference_compare_blur_matrices()


@pytest.mark.parametrize("first_bin", range(0, job.N_ANGLE_BINS, BINS_PER_CASE))
def test_brief_table_shortcut_equals_reference_einsum(tables, first_bin):
    """Bit-equal f32 rows and zero padding, bin by bin."""
    D, B, fast = tables
    for a in range(first_bin, first_bin + BINS_PER_CASE):
        Dm = D[a].reshape(256, job.BRIEF_PATCH, job.BRIEF_PATCH)
        # the reference's own contraction (orient_brief._compare_blur_matrices)
        want = np.einsum("bil,ij,lk->bjk", Dm, B, B).reshape(256, -1).astype(np.float32)
        rows = fast[a * 256:(a + 1) * 256]
        np.testing.assert_array_equal(rows[:, :job.RAW_FLAT], want, err_msg=f"bin {a}")
        assert not rows[:, job.RAW_FLAT:].any()
