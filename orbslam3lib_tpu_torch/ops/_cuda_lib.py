"""Build and load the port's CUDA kernels (`csrc/*.cu`) as one shared library.

nvcc compiles the sources, which have a plain C interface and include no
PyTorch header (`csrc/lie.cuh` holds the Lie helpers two of them share),
one process per source, all started together, and links them into
`build/orbslam3lib_tpu_torch/libkernels.so` at the root of the checkout, at
first use; `ctypes` loads it. ptxas reports each kernel's registers,
shared memory and spills (`-Xptxas -v`); the last build's report is kept in
`BUILD_LOG`. A stamp file beside the library holds the SHA-256 of the
sources, the header and the flags: the library is rebuilt when any of them
changes. Nothing here runs at import time, so modules that import this one
stay importable on a machine without nvcc or a card.
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
SOURCES = ("fast_nms.cu", "knn2.cu", "pose_opt.cu", "vi_opt.cu")
HEADERS = ("lie.cuh",)   # included by the sources: part of the stamp
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "fast_nms_levels_launch": (_P, _I, _P, _I, _P),
    "knn2_launch": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P),
    "pose_eval_launch": (_P,) * 8 + (_F, _I) + (_P,) * 5,
    "pose_step_launch": (_P,) * 10 + (_F, _I) + (_P,) * 3,
    "vi_eval_launch": (_P,) * 5 + (_F, _F, _F, _I, _I) + (_P,) * 2,
    "vi_step_launch": (_P,) * 4 + (_I, _I) + (_P,) * 8,
}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""


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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def compile_library(sources, out_path: Path):
    """Compile `sources` (paths of .cu files) with one nvcc process each, all
    started together, and link them into the shared library `out_path`.
    Returns (wall seconds, nvcc's output). Links into a temporary file, then
    renames it into place, so that a concurrent loader never sees a
    half-written library."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_path.parent) as tmp:
        objs = [os.path.join(tmp, f"{i}_{Path(src).stem}.o") for i, src in enumerate(sources)]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" + log)
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(link) + "\n"
                               + proc.stdout + proc.stderr)
        os.replace(os.path.join(tmp, "lib.so"), out_path)
    return time.perf_counter() - t0, "".join(logs)


def build() -> float:
    """Compile the sources with nvcc now, whatever is on disk; returns the
    build's wall time in seconds."""
    global BUILD_LOG
    digest = _digest()
    seconds, BUILD_LOG = compile_library([CSRC / s for s in SOURCES], LIB_PATH)
    (BUILD_DIR / "libkernels.sha256").write_text(digest)
    return seconds


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
