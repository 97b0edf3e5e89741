"""Build the CUDA sources of ``pytorchrec_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone into ``pytorchrec_tpu_torch/_build/<name>_<hash>.so``, which is loaded
with ``ctypes``. The hash covers the source and the flags, so an edited
source never reuses a stale library. ``build`` starts one ``nvcc`` for each
missing source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600

_LIBRARIES: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: install the CUDA toolkit or set CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named source that has no library yet; return the paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: library_path(name) for name in names}
    missing = {name: path for name, path in targets.items() if not path.exists()}
    if not missing:
        return targets
    nvcc = _nvcc()
    running = {}
    try:
        for name, path in missing.items():
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True), tmp)
        failures = []
        for name, (proc, tmp) in running.items():
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(f"{name}.cu:\n{log}")
            else:
                os.replace(tmp, missing[name])  # atomic: concurrent builds agree
        if failures:
            raise RuntimeError("nvcc failed for " + "\n".join(failures))
    finally:
        for proc, tmp in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBRARIES:
        _LIBRARIES[name] = ctypes.CDLL(str(build(name)[name]))
    return _LIBRARIES[name]
