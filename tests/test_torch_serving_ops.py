"""The scoring kernels as ``torch.library`` ops, on the CPU.

B1 (``cross_network``), B6's forward (``fm_interaction``) and B5
(``din_attention_pool``) are ops of the ``pytorchrec`` namespace: each is
held to ``torch.library.opcheck``, to its wrapper's plain version (its CPU
implementation, so equal bit for bit) and to the path a call takes: the
no-grad wrapper, the autograd Function's forward and ``torch.export`` all
run the op. The C++ side of the Python-free server
(``csrc/serving_ops.cpp``) is held to the Python one: its three schemas
equal the registered ones, and a small program built with ``g++`` from
``csrc/serving_plans.h`` gives ``cross_plan``'s and ``tile_plan``'s plans over
a grid of shapes. Inputs are numpy draws from a seed.
"""

import itertools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pytorchrec_tpu_torch.ops.kernels import SCHEMAS, cross, din_attention, fm
from pytorchrec_tpu_torch.ops.kernels.cross import cross_plan
from pytorchrec_tpu_torch.ops.kernels.din_attention import tile_plan

CSRC = Path(__file__).resolve().parents[1] / "pytorchrec_tpu_torch" / "csrc"
OPS = {"cross_network": cross.CROSS_OP, "fm_interaction": fm.FM_OP,
       "din_attention_pool": din_attention.DIN_OP}


def _f32(rng, *shape, scale=0.1):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "cross_network":
        return (_f32(rng, 5, 7), _f32(rng, 2, 7, 7), _f32(rng, 2, 7))
    if name == "fm_interaction":
        return (_f32(rng, 6, 4, 3),)
    e, hidden = 4, (8, 6)
    dims = [4 * e, *hidden, 1]
    params = []
    for i in range(len(dims) - 1):
        params += [_f32(rng, dims[i], dims[i + 1]), _f32(rng, dims[i + 1])]
    valid = torch.from_numpy((rng.random((3, 5)) < 0.7).astype(np.int32))
    valid[:, 0] = 1
    return (_f32(rng, 3, 5, e), _f32(rng, 3, 2, e), valid, params, "sigmoid")


def _plain(name, args):
    if name == "cross_network":
        return cross.cross_network_plain(*args)
    if name == "fm_interaction":
        return fm.fm_interaction_plain(*args)
    return din_attention.din_attention_pool_plain(*args)


def _wrapper(name, args):
    if name == "cross_network":
        return cross.cross_network(*args)
    if name == "fm_interaction":
        return fm.fm_interaction(*args)
    return din_attention.din_attention_pool(*args)


class _OpLog(TorchDispatchMode):
    """The ``pytorchrec`` ops dispatched inside."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "pytorchrec":
            self.ops.append(func._opname)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(OPS))
def test_opcheck(name):
    torch.library.opcheck(OPS[name], _inputs(name))


@pytest.mark.parametrize("name", list(OPS))
def test_op_equals_the_plain_version(name):
    args = _inputs(name, seed=1)
    got = OPS[name](*args)
    assert torch.equal(got, _plain(name, args))
    assert torch.equal(_wrapper(name, args), got)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("name", list(OPS))
def test_wrapper_runs_the_op_with_and_without_grad(name, grad):
    """The no-grad branch and the autograd Function's forward both run the
    op (eager, captured and exported scoring take one path); the backward
    is the Function's."""
    args = _inputs(name, seed=2)
    if grad:
        first = args[0].clone().requires_grad_()
        args = (first, *args[1:])
    with _OpLog() as log:
        out = _wrapper(name, args)
    assert log.ops == [name]
    assert (out.grad_fn is not None) == grad
    if grad:
        out.sum().backward()
        assert first.grad is not None and torch.isfinite(first.grad).all()


@pytest.mark.parametrize("name", list(OPS))
def test_export_keeps_the_op_and_no_autograd_function(name):
    """``torch.export`` of a module calling the wrapper on parameters that
    require grad, under ``no_grad``: the graph calls the op once and holds
    no autograd Function."""
    args = _inputs(name, seed=3)
    tensors = tuple(a for a in args[1:] if isinstance(a, torch.Tensor))
    extra = args[len(tensors) + 1:]  # DIN's params and activation stay Python values

    class Caller(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.first = torch.nn.Parameter(args[0].clone())

        def forward(self, *rest):
            return _wrapper(name, (self.first, *rest, *extra))

    module, rest = Caller(), tensors
    with torch.no_grad():
        program = torch.export.export(module, rest)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(f"pytorchrec.{name}.default") == 1
    assert not any("autograd" in t.lower() for t in targets)
    with torch.no_grad():
        torch.testing.assert_close(program.module()(*rest), _plain(name, args), rtol=0, atol=0)


def test_cpp_schemas_equal_the_python_ones():
    source = (CSRC / "serving_ops.cpp").read_text()
    cpp = re.findall(r'm\.def\("([^"]+)"\)', source)
    assert cpp == list(SCHEMAS.values())
    for name, op in OPS.items():
        assert str(op._schema) == f"pytorchrec::{SCHEMAS[name]}"


def test_cpp_sources_include_nothing_of_jax_or_pjrt():
    sources = [CSRC / "serving_ops.cpp", CSRC / "serving_plans.h",
               CSRC.parent / "native" / "serving" / "aoti_serving.cpp"]
    for source in sources:
        includes = re.findall(r"#include\s+[<\"]([^>\"]+)", source.read_text())
        assert not [i for i in includes if re.search(r"pjrt|xla|jax|pytorchrec_tpu/", i)], source
        assert "torch/extension.h" not in includes


_PLAN_PROGRAM = r"""
#include <cstdio>
#include <vector>
#include "serving_plans.h"
int main() {
  char kind;
  while (std::scanf(" %c", &kind) == 1) {
    if (kind == 'c') {
      long long batch; int d, sms;
      std::scanf("%lld %d %d", &batch, &d, &sms);
      auto p = pytorchrec_serving::PlanCross(batch, d, sms);
      std::printf("%d %d %d\n", p.fused ? 1 : 0, p.tile, p.slice_k);
    } else {
      int e, s, n; long long limit;
      std::scanf("%d %d %lld %d", &e, &s, &limit, &n);
      std::vector<int> hidden(n);
      for (int& h : hidden) std::scanf("%d", &h);
      std::printf("%lld %lld\n", pytorchrec_serving::PlanDinRows(e, s, hidden, limit),
                  pytorchrec_serving::DinSmemBytes(e, s, hidden, 1));
    }
  }
}
"""

CROSS_BATCHES = (1, 2, 5, 8, 9, 16, 33, 100, 129, 256, 512, 1000, 1536, 2000, 4096, 4097, 8191,
                 8192, 25600, 32768, 100000)
CROSS_WIDTHS = (1, 4, 13, 37, 64, 100, 256, 429, 512, 513, 700, 1024, 1677, 2048, 4096)
DIN_HIDDEN = ((80, 40), (16, 8), (160,), (200, 80, 40), (1, 2, 3, 4, 5, 6, 7), (1,) * 8, (512,))
DIN_LIMITS = (232448, 101376, 49152, 20000)


@pytest.fixture(scope="module")
def plan_program(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    work = tmp_path_factory.mktemp("plans")
    (work / "plans.cpp").write_text(_PLAN_PROGRAM)
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{CSRC}", str(work / "plans.cpp"), "-o",
                    str(work / "plans")], check=True, capture_output=True, timeout=300)
    return str(work / "plans")


def _ask(program, lines):
    run = subprocess.run([program], input="\n".join(lines) + "\n", capture_output=True,
                         text=True, timeout=120, check=True)
    return run.stdout.splitlines()


def test_cpp_cross_plan_equals_python(plan_program):
    shapes = list(itertools.product(CROSS_BATCHES, CROSS_WIDTHS, (132, 114, 78)))
    got = _ask(plan_program, [f"c {b} {d} {sm}" for b, d, sm in shapes])
    for (b, d, sm), line in zip(shapes, got):
        plan = cross_plan(b, d, sm)
        want = (f"{int(plan.form == 'fused')} {-1 if plan.tile is None else plan.tile} "
                f"{plan.slice_k}")
        assert line == want, (b, d, sm)


def test_cpp_din_tile_plan_equals_python(plan_program):
    shapes = list(itertools.product((8, 16, 40, 64, 128), (1, 5, 20, 100, 127, 128, 129, 1000,
                                                           8192, 8193), DIN_HIDDEN, DIN_LIMITS))
    got = _ask(plan_program, [f"d {e} {s} {limit} {len(h)} {' '.join(map(str, h))}"
                              for e, s, h, limit in shapes])
    raised = 0
    for (e, s, hidden, limit), line in zip(shapes, got):
        rows, smem_one = map(int, line.split())
        try:
            want = tile_plan(e, s, hidden, limit).rows
        except ValueError:
            want, raised = 0, raised + 1
        assert rows == want, (e, s, hidden, limit)
        assert smem_one == din_attention.smem_bytes(e, s, hidden, 1)
    assert 0 < raised < len(shapes)  # both outcomes are on the grid
