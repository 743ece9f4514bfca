"""Build and load the port's CUDA kernels (`csrc/*.cu`) as one shared library.

nvcc compiles the sources, which have a plain C interface and include no
PyTorch header, into `build/orbslam3lib_tpu_torch/libkernels.so` at the root
of the checkout, at first use; `ctypes` loads it. A stamp file beside the
library holds the SHA-256 of the sources and the flags: the library is
rebuilt when either changes. Nothing here runs at import time, so modules
that import this one stay importable on a machine without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "orbslam3lib_tpu_torch"
LIB_PATH = BUILD_DIR / "libkernels.so"
SOURCES = ("fast_nms.cu", "knn2.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "fast_nms_launch": (_P, _P, _I, _I, _I, _I, _P),
    "knn2_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of orbslam3lib_tpu_torch cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build() -> float:
    """Compile the sources with nvcc now, whatever is on disk; returns the
    build's wall time in seconds. Compiles into a temporary file, then
    renames it into place, so that a concurrent loader never sees a
    half-written library."""
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    (BUILD_DIR / "libkernels.sha256").write_text(digest)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            stamp = BUILD_DIR / "libkernels.sha256"
            if not (LIB_PATH.exists() and stamp.exists()
                    and stamp.read_text() == _digest()):
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
