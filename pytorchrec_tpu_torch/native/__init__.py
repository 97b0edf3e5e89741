"""Host-side native loops in C++ through ctypes (port of
``pytorchrec_tpu/native/__init__.py``).

``fastrec.cpp`` compiles with ``g++`` at first use into
``pytorchrec_tpu_torch/_build/fastrec_<hash>.so``, the hash covering the
source and the flags (as ``ops/kernels/build.py`` names the CUDA
libraries), and exposes:

* ``neg_sample``: per-row rejection sampling against a sorted positive-key
  set (the readers' per-epoch pair-wise sampler, ``neg_sample_mode="fast"``);
* ``history_matrix``: the preceding-event history arrays of the processing
  pipeline (``data/process/history.py``), equal to its numpy version.

Unlike the JAX package, which falls back to numpy where the build fails,
a failed build raises here: nothing chooses the numpy version in its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastrec.cpp"
BUILD_DIR = SOURCE.parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 300

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where ``fastrec.cpp`` builds to: named by a hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"fastrec_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; raise with g++'s output if it fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data loops need a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    try:
        run = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{run.stdout}{run.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builds agree
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.fastrec_neg_sample.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.fastrec_history.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.fastrec_neg_sample.restype = lib.fastrec_history.restype = None
            _LIB = lib
    return _LIB


def _as_c(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def neg_sample(uids: np.ndarray, lo: int, hi: int, pos_keys_sorted: np.ndarray,
               seed: int) -> np.ndarray:
    """Per-row negative iid in [lo, hi) avoiding (uid*hi + iid) in pos_keys."""
    lib = _lib()
    uids = np.ascontiguousarray(uids, dtype=np.int32)
    pos_keys_sorted = np.ascontiguousarray(pos_keys_sorted, dtype=np.int64)
    out = np.empty(len(uids), dtype=np.int32)
    lib.fastrec_neg_sample(
        _as_c(uids, ctypes.c_int32), len(uids), lo, hi,
        _as_c(pos_keys_sorted, ctypes.c_int64), len(pos_keys_sorted),
        ctypes.c_uint64(seed), _as_c(out, ctypes.c_int32),
    )
    return out


def history_matrix(uids: np.ndarray, iids: np.ndarray, event_mask: np.ndarray,
                   k: int, inclusive: bool) -> np.ndarray:
    """Equal to ``data/process/history.py::_history_matrix``: the rows
    sorted by uid (stably) for the C++ loop, and put back after."""
    lib = _lib()
    n = len(uids)
    order = np.argsort(uids, kind="stable")
    inv_order = np.argsort(order, kind="stable")
    s_uids = np.ascontiguousarray(uids[order], dtype=np.int32)
    s_iids = np.ascontiguousarray(iids[order], dtype=np.int32)
    s_mask = np.ascontiguousarray(event_mask[order], dtype=np.uint8)
    out = np.empty((n, k + 1), dtype=np.int32)
    lib.fastrec_history(
        _as_c(s_uids, ctypes.c_int32), _as_c(s_iids, ctypes.c_int32),
        _as_c(s_mask, ctypes.c_uint8), n, k, int(inclusive),
        _as_c(out, ctypes.c_int32),
    )
    return out[inv_order]
