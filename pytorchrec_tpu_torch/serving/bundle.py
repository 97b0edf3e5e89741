"""Serving-bundle export (port of ``pytorchrec_tpu/serving/bundle.py``):
everything the Python-free server needs, in one directory.

``export_serving_bundle(trainer, sample_batch, out_dir, tolerance=1e-4)``
writes:

* ``model.pt2``: the AOTInductor package
  (``torch._inductor.aoti_compile_and_package``) of ``Trainer.
  export_program``'s program, for the trainer's device: the parameters baked
  in, shapes fixed to the sample batch's, the scoring kernels kept as
  ``torch.ops.pytorchrec`` ops;
* ``serving_ops.so``: the ops library (``csrc/serving_ops.cpp``, built by
  ``ops/kernels/build.py``), which registers those ops in C++ and, for the
  card, launches the kernels. It is copied in, so the directory stands alone;
* ``input_<i>.bin`` and ``expected_<i>.bin``: raw little-endian tensors, the
  program's kept inputs (the batch keys whose values reach the scores, in
  sorted key order: the label is dropped) and the live scorer's
  (``make_serving_fn``) scores for them;
* ``manifest.txt``, in the JAX package's grammar for the lines the two share
  (``input <dtype> <dims> <file> <name>``, ``expected <dtype> <dims> <file>``,
  ``tolerance <x>``), with ``program <file>``, ``ops_library <file>`` and one
  ``op <name> <launches>`` line for each op the program holds: the kernel
  launches one request makes (0 on the CPU, whose ops run the plain
  versions). The server checks its counts against them;
* ``export.json``: the export's and the compile's seconds.

The JAX bundle's ``plugin``, ``env`` and ``opt`` lines, and its
``compile_options.pb``, configure a PJRT plugin and have no counterpart.

The consumer is ``native/serving/aoti_serving.cpp``, built at first use by
``shim_binary_path()``: ``<binary> <bundle_dir> [--reps N] [--dry]``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Mapping

import numpy as np
import torch

from pytorchrec_tpu_torch.ops.kernels import NAMESPACE, build

_DTYPE_CODES = {
    np.dtype(np.float32): "f32",
    np.dtype(np.float64): "f64",
    np.dtype(np.int32): "i32",
    np.dtype(np.int64): "i64",
    np.dtype(np.uint32): "u32",
    np.dtype(np.int8): "i8",
    np.dtype(np.uint8): "u8",
}
PROGRAM, OPS_LIBRARY = "model.pt2", "serving_ops.so"


def _dtype_code(arr: np.ndarray) -> str:
    code = _DTYPE_CODES.get(np.dtype(arr.dtype))
    if code is None:
        raise ValueError(f"unsupported dtype for serving bundle: {arr.dtype}")
    return code


def _dims_csv(arr: np.ndarray) -> str:
    return ",".join(str(d) for d in arr.shape) if arr.ndim else "scalar"


def _host(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(value))


def _wrappers() -> dict:
    """The kernel wrappers whose counts the ops' launches go to, by op name."""
    from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
    from pytorchrec_tpu_torch.ops.kernels.din_attention import din_attention_pool
    from pytorchrec_tpu_torch.ops.kernels.fm import fm_interaction

    return {"cross_network": cross_network, "fm_interaction": fm_interaction,
            "din_attention_pool": din_attention_pool}


def _program_ops(program: "torch.export.ExportedProgram") -> list:
    """The names of the ``pytorchrec`` ops in ``program``'s graph, in order
    of first use."""
    names = []
    for node in program.graph.nodes:
        target = getattr(node.target, "namespace", None)
        if node.op == "call_function" and target == NAMESPACE:
            name = node.target._opname
            if name not in names:
                names.append(name)
    return names


def shim_binary_path() -> str:
    """The server binary (``native/serving/aoti_serving.cpp``), built with
    ``g++`` against the torch wheel at first use."""
    return str(build.server_binary())


def export_serving_bundle(trainer: Any, sample_batch: Mapping[str, Any], out_dir: str, *,
                          tolerance: float = 1e-4) -> str:
    """Export ``trainer``'s scorer as a bundle the C++ server scores (see
    the module docstring). Returns ``out_dir``. The live scorer runs once on
    ``sample_batch`` to record the expected scores, and the exported program
    once to count the kernel launches of a request."""
    start = time.perf_counter()
    program, keys = trainer.export_program(sample_batch)
    export_s = time.perf_counter() - start
    os.makedirs(out_dir, exist_ok=True)

    expected = _host(trainer.make_serving_fn()(sample_batch)).astype(np.float32)
    wrappers = _wrappers()
    ops = _program_ops(program)
    before = {name: wrappers[name].launches for name in ops}
    module = program.module()
    with torch.no_grad():
        module(*(torch.as_tensor(sample_batch[k]).to(trainer.device) for k in keys))
    per_request = {name: wrappers[name].launches - before[name] for name in ops}

    from torch._inductor import aoti_compile_and_package  # loaded at first export

    configs = {"cpp.cxx": (build.CXX,)}
    if trainer.device.type == "cuda":
        # a package for the card runs no CPU kernel: skip the CPU vector-ISA
        # probe builds, most of a process's first compile there (PERF.md)
        configs["cpp.vec_isa_ok"] = False
    start = time.perf_counter()
    aoti_compile_and_package(program, package_path=os.path.join(out_dir, PROGRAM),
                             inductor_configs=configs)
    compile_s = time.perf_counter() - start
    shutil.copyfile(build.serving_ops_library(trainer.device.type == "cuda"),
                    os.path.join(out_dir, OPS_LIBRARY))

    lines = [f"program {PROGRAM}", f"ops_library {OPS_LIBRARY}"]
    for slot, key in enumerate(keys):
        arr = _host(sample_batch[key])
        fname = f"input_{slot}.bin"
        arr.tofile(os.path.join(out_dir, fname))
        lines.append(f"input {_dtype_code(arr)} {_dims_csv(arr)} {fname} {key}")
    lines.append(f"expected {_dtype_code(expected)} {_dims_csv(expected)} expected_0.bin")
    expected.tofile(os.path.join(out_dir, "expected_0.bin"))
    lines += [f"op {name} {n}" for name, n in per_request.items()]
    lines.append(f"tolerance {tolerance}")
    with open(os.path.join(out_dir, "manifest.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(out_dir, "export.json"), "w") as f:
        json.dump({"export_s": export_s, "compile_s": compile_s, "keys": keys,
                   "launches_per_request": per_request}, f)
    return out_dir
