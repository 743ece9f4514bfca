"""orbslam3lib_tpu_torch — the PyTorch + CUDA port of `orbslam3lib_tpu`.

Module paths mirror the JAX package (`ops/`, `tracking/`, `models/`,
`mapping/`, `utils/`, `io/`), so each module's counterpart is found by name.
The port imports torch and numpy only; the JAX package is its reference and
the parity tests (`tests/test_torch_*.py`) hold one against the other.

The two TPU (Pallas) kernels of the JAX package are hand-written CUDA C++
for Hopper (`csrc/`), built with nvcc at first use; see `ops/cuda_fast.py`
and `ops/cuda_matcher.py`.
"""

__version__ = "0.1.0"

from . import device as _device  # noqa: F401  (sets the no-TF32 policy)
