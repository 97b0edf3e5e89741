"""Build the CUDA sources of ``pytorchrec_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone into ``pytorchrec_tpu_torch/_build/<name>_<hash>.so``, which is loaded
with ``ctypes``. The hash covers the source, every shared header
``csrc/*.cuh`` (a source may include any of them) and the flags, so an
edited source or header never reuses a stale library. ``build`` starts one
``nvcc`` for each missing source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence

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
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source, of
    each ``.cuh`` header beside it (name and content) and of the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


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


# ---------------------------------------------------------------- the server

SERVING_OPS = CSRC / "serving_ops.cpp"
SERVING_KERNELS = ("cross", "fm", "din_attention")  # the kernels the ops launch
SERVER = _PACKAGE / "native" / "serving" / "aoti_serving.cpp"
# the host compiler of the ops library, the server and the AOTInductor
# package's wrapper (serving/bundle.py): the g++ on PATH, which links OpenMP
# (AOTInductor passes -fopenmp), whatever CXX names
CXX = "g++"
CXX_TIMEOUT_S = 600


def _cuda_home() -> Path:
    return Path(_nvcc()).resolve().parents[1]


def _torch_flags(cuda: bool) -> Dict[str, List[str]]:
    """g++'s compile and link flags against the torch wheel; ``cuda`` adds
    the CUDA headers and torch's CUDA libraries (the ops library's kernels)."""
    import torch
    from torch.utils import cpp_extension

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    compile_flags = ["-std=c++17", "-O2", "-w", f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
    compile_flags += [f"-I{path}" for path in cpp_extension.include_paths()]
    link = []
    for path in cpp_extension.library_paths():
        link += [f"-L{path}", f"-Wl,-rpath,{path}"]
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        compile_flags += ["-DSERVING_OPS_CUDA", f"-I{_cuda_home() / 'include'}"]
    if cuda or _has_torch_cuda():
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    return {"compile": compile_flags, "link": link + ["-Wl,--no-as-needed", *libs, "-ldl"]}


def _has_torch_cuda() -> bool:
    """Whether the torch wheel has its CUDA library: the server links it, so
    that a package for the card finds its runtime."""
    from torch.utils import cpp_extension

    return any((Path(p) / "libtorch_cuda.so").exists() for p in cpp_extension.library_paths())


def _digest(sources: Sequence[Path], flags: Sequence[str]) -> str:
    import torch

    digest = hashlib.sha256(torch.__version__.encode())
    for source in sources:
        digest.update(source.name.encode() + b"\0" + source.read_bytes())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def _run_all(commands: Sequence[List[str]], what: str) -> None:
    """Start every command at once and wait for them together; raise with
    the output of each that failed."""
    running = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)) for cmd in commands]
    failures = []
    try:
        for cmd, proc in running:
            log, _ = proc.communicate(timeout=CXX_TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\n{log}")
    finally:
        for _, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError(f"building {what} failed:\n" + "\n".join(failures))


_BUILD_LOCKS: Dict[Path, threading.Lock] = defaultdict(threading.Lock)


def _built(path: Path, steps) -> Path:
    """``path`` if it exists, else run ``steps(work_dir, tmp)`` (lists of
    commands run at once, one list after another) and move ``tmp`` there
    atomically. One build of a path at a time in a process."""
    with _BUILD_LOCKS[path]:
        if path.exists():
            return path
        if shutil.which(CXX) is None:
            raise RuntimeError("g++ not found: the serving ops and the server need a C++ "
                               "compiler")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix=f"{path.name}.", dir=BUILD_DIR))
        tmp = work / path.name
        try:
            for commands in steps(work, tmp):
                _run_all(commands, path.name)
            os.replace(tmp, path)  # atomic: concurrent builds agree
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return path


def serving_ops_library(cuda: bool) -> Path:
    """Build (once) and return the ops library: for CUDA tensors with the
    kernels (nvcc and g++), else the CPU's plain versions (g++ alone)."""
    flags = _torch_flags(cuda)

    def steps(work: Path, tmp: Path):
        ops = [*flags["compile"], "-fPIC", "-c", str(SERVING_OPS), "-o",
               str(work / "serving_ops.o")]
        if not cuda:
            yield [[CXX, *ops]]
            yield [[CXX, "-shared", str(work / "serving_ops.o"), "-o", str(tmp),
                    *flags["link"]]]
            return
        nvcc = _nvcc()
        objects = [work / f"{name}.o" for name in SERVING_KERNELS]
        kernel_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        yield [[CXX, *ops]] + [[nvcc, *kernel_flags, "-c", str(CSRC / f"{name}.cu"), "-o",
                                  str(obj)] for name, obj in zip(SERVING_KERNELS, objects)]
        # nvcc links the CUDA runtime the kernels' objects need
        links = []
        for flag in flags["link"]:
            links += ["-Xlinker", flag[4:]] if flag.startswith("-Wl,") else [flag]
        yield [[nvcc, "-shared", "-o", str(tmp), str(work / "serving_ops.o"),
                *map(str, objects), *links]]

    sources = [SERVING_OPS, CSRC / "serving_plans.h"]
    if cuda:
        sources += [CSRC / f"{name}.cu" for name in SERVING_KERNELS]
        sources += sorted(CSRC.glob("*.cuh"))
    digest = _digest(sources, [*flags["compile"], *flags["link"], *NVCC_FLAGS])
    return _built(BUILD_DIR / f"serving_ops_{'cuda' if cuda else 'cpu'}_{digest}.so", steps)


def server_binary() -> Path:
    """Build (once) and return the server."""
    flags = _torch_flags(False)

    def steps(work: Path, tmp: Path):
        yield [[CXX, *flags["compile"], str(SERVER), "-o", str(tmp), *flags["link"]]]

    digest = _digest([SERVER], flags["compile"] + flags["link"])
    return _built(BUILD_DIR / f"aoti_serve_{digest}", steps)
