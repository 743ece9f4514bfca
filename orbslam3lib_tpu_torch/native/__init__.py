"""The native (C++) BoW runtime: the vocabulary tree's descent and an
inverted-file keyframe database, bound through ctypes (port of
`orbslam3lib_tpu/native/`, whose copy of this module cannot be imported
from the port).

The reference keeps its keyframe database on the host in C++ (DBoW2's
KeyFrameDatabase): a descent is a pointer chase, and a query touches only
the keyframes that share a word with it. The dense database of
`tracking/reloc.PlaceRecognition` stays the oracle and the on-device route.

`bow.cpp` is compiled with g++ at first use into
`build/orbslam3lib_tpu_torch/libbow.so` at the root of the checkout, never
beside the source, and rebuilt when the SHA-256 of the source and the flags
(kept beside the library) changes. `library()` raises with the compiler's
output when the build fails; `load_library()` returns None instead and
keeps the reason in `LOAD_ERROR`, for callers that may take the dense
database. Nothing runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "bow.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "orbslam3lib_tpu_torch"
LIB_PATH = BUILD_DIR / "libbow.so"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
LOAD_ERROR: Optional[str] = None

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
# C entry point -> (argtypes, restype)
SIGNATURES = {
    "bow_descend": ([_u64p, _i64p, ctypes.c_int, ctypes.c_int, _u64p, ctypes.c_int,
                     _i32p], None),
    "bowdb_create": ([ctypes.c_int, ctypes.c_int, _f32p], ctypes.c_void_p),
    "bowdb_destroy": ([ctypes.c_void_p], None),
    "bowdb_add": ([ctypes.c_void_p, ctypes.c_int, _i32p, _u8p, ctypes.c_int], None),
    "bowdb_query": ([ctypes.c_void_p, _i32p, _u8p, ctypes.c_int, _f32p], None),
    "bowdb_n_active": ([ctypes.c_void_p], ctypes.c_int),
}


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()


def build() -> None:
    """Compile `bow.cpp` with g++ now, into a temporary file renamed into
    place (a concurrent loader never sees half a library)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++ on PATH): the native BoW "
                           "library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "libbow.so")
        cmd = [cxx, *CXX_FLAGS, "-o", out, str(SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed:\n" + " ".join(cmd) + "\n"
                               + proc.stdout + proc.stderr)
        os.replace(out, LIB_PATH)
    (BUILD_DIR / "libbow.sha256").write_text(_digest())


def library() -> ctypes.CDLL:
    """The loaded library, built first if missing or stale; raises if it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            stamp = BUILD_DIR / "libbow.sha256"
            if not (LIB_PATH.exists() and stamp.exists() and stamp.read_text() == _digest()):
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def load_library() -> Optional[ctypes.CDLL]:
    """`library()`, or None when it cannot be built or loaded (the reason
    in `LOAD_ERROR`)."""
    global LOAD_ERROR
    try:
        return library()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        LOAD_ERROR = f"{type(e).__name__}: {e}"
        return None


def _numpy(x, dtype) -> np.ndarray:
    """A tensor (on any device) or an array as a C-contiguous numpy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def pack_descriptors(desc_bits) -> np.ndarray:
    """(N, 256) 0/1 bits -> (N, 4) uint64, bit i of a byte is descriptor
    bit 8 * byte + i (little-endian bit order)."""
    b = np.packbits(_numpy(desc_bits, np.uint8), axis=1, bitorder="little")
    return np.ascontiguousarray(b).view(np.uint64)


class NativeVocabulary:
    """The vocabulary tree packed for the native descent: every level's
    centroids as 4 x uint64, concatenated, with each level's offset."""

    def __init__(self, voc):
        self.k = voc.k
        self.depth = voc.depth
        self.n_words = voc.n_words
        self.idf = _numpy(voc.idf, np.float32)
        packed = [pack_descriptors(c) for c in voc.centroids]
        self._levels = np.ascontiguousarray(np.concatenate(packed))
        self._offsets = np.cumsum([0] + [p.shape[0] for p in packed[:-1]]).astype(np.int64)

    def word_ids(self, desc_bits) -> np.ndarray:
        """(N,) int32 leaf word of each descriptor (the lowest child on
        ties, as `models/vocabulary.word_ids`)."""
        lib = library()
        d = pack_descriptors(desc_bits)
        out = np.empty(d.shape[0], np.int32)
        lib.bow_descend(_ptr(self._levels, _u64p), _ptr(self._offsets, _i64p),
                        self.k, self.depth, _ptr(d, _u64p), d.shape[0], _ptr(out, _i32p))
        return out


class NativeBowDatabase:
    """Inverted-file keyframe database (KeyFrameDatabase.cc) with the dense
    database's contract: `add`, `query`, `query_scores`, `n_active` and
    `.voc` (the vocabulary it was built from). Descriptors and masks may be
    tensors on any device; they are read to the host."""

    def __init__(self, voc, max_kf: int):
        self.voc = voc
        self.nvoc = NativeVocabulary(voc)
        self.max_kf = max_kf
        self._lib = library()
        self._h = self._lib.bowdb_create(self.nvoc.n_words, max_kf,
                                         _ptr(self.nvoc.idf, _f32p))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.bowdb_destroy(h)

    def _words(self, desc_bits, valid):
        return self.nvoc.word_ids(desc_bits), _numpy(valid, np.uint8)

    def add(self, kf_id: int, desc_bits, valid) -> None:
        """Index keyframe `kf_id` (a re-add replaces its postings)."""
        words, v = self._words(desc_bits, valid)
        self._lib.bowdb_add(self._h, int(kf_id), _ptr(words, _i32p), _ptr(v, _u8p),
                            len(words))

    def query_scores(self, desc_bits, valid) -> np.ndarray:
        """(max_kf,) DBoW2 L1 similarity per keyframe; -1 at inactive slots."""
        words, v = self._words(desc_bits, valid)
        out = np.empty(self.max_kf, np.float32)
        self._lib.bowdb_query(self._h, _ptr(words, _i32p), _ptr(v, _u8p), len(words),
                              _ptr(out, _f32p))
        return out

    def query(self, desc_bits, valid, exclude_mask=None, n_best: int = 3):
        """(ids (n_best,) int32, scores (n_best,)), best first; equal scores
        keep the lower keyframe id first, as the dense database's."""
        s = self.query_scores(desc_bits, valid)
        if exclude_mask is not None:
            s = np.where(_numpy(exclude_mask, bool), np.float32(-1.0), s)
        top = np.argsort(-s, kind="stable")[:n_best]
        return top.astype(np.int32), s[top]

    @property
    def n_active(self) -> int:
        return int(self._lib.bowdb_n_active(self._h))
