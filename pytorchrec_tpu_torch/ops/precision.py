"""The train step's matmul precision (the JAX trainer's
``compile(matmul_precision=...)``, which traces its step under
``jax.default_matmul_precision``).

``"bfloat16"`` runs the dense products of a train step, forward and
backward, on bf16-rounded operands with f32 results and f32 accumulation:
on the card one bf16 cuBLAS GEMM with an f32 output (``torch.mm(...,
out_dtype=torch.float32)``), on the CPU its plain emulation (each operand
rounded to bf16 and back, then an f32 product). The products it covers are
the linear layers built by ``ops/mlp.py::linear`` (``dense_linear``) and the
GEMMs of ``CrossNetworkFunction``'s backward (``precision_mm``); B1's forward
kernel stays f32. ``None``, ``"float32"`` and ``"highest"`` are full f32,
the trainer's default. The precision is set for the train step's body only
(``matmul_precision``, a context of the thread that runs the forward, as
``jax.default_matmul_precision`` is): serving never runs under it. A
backward runs at the precision its forward recorded.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

BFLOAT16 = "bfloat16"
# the names compile(matmul_precision=...) takes; all but bfloat16 are full f32
PRECISIONS = (None, "float32", "highest", BFLOAT16)

_current: contextvars.ContextVar = contextvars.ContextVar("matmul_precision", default=None)


def check_precision(precision: Optional[str]) -> Optional[str]:
    """``precision`` as the trainer keeps it: ``"bfloat16"`` or None (full
    f32). Any other name raises."""
    if precision not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {PRECISIONS}, got {precision!r}")
    return BFLOAT16 if precision == BFLOAT16 else None


@contextlib.contextmanager
def matmul_precision(precision: Optional[str]) -> Iterator[None]:
    """Run the block's dense products at ``precision`` (see the module
    docstring); the previous precision comes back after it."""
    token = _current.set(check_precision(precision))
    try:
        yield
    finally:
        _current.reset(token)


def current_precision() -> Optional[str]:
    return _current.get()


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D f32 tensors on bf16-rounded operands, an f32 result
    with f32 accumulation."""
    if a.is_cuda:
        return torch.mm(a.bfloat16(), b.bfloat16(), out_dtype=torch.float32)
    return torch.mm(a.bfloat16().float(), b.bfloat16().float())


def precision_mm(a: torch.Tensor, b: torch.Tensor, precision: Optional[str],
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a @ b (+ bias)`` at ``precision``; at full f32 one ``torch.mm`` or
    ``torch.addmm``."""
    if precision == BFLOAT16:
        out = bf16_mm(a, b)
        return out if bias is None else out + bias
    return torch.mm(a, b) if bias is None else torch.addmm(bias, a, b)


class _BF16Linear(torch.autograd.Function):
    """``x @ w.T + b`` with every product on bf16-rounded operands, the
    backward's two (``g @ w`` and ``g.T @ x``) included, as JAX's transposed
    dots run under the same precision."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        flat = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(flat, weight)
        ctx.has_bias = bias is not None
        out = bf16_mm(flat, weight.t())
        if bias is not None:
            out = out + bias
        return out.reshape(*x.shape[:-1], weight.shape[0])

    @staticmethod
    def backward(ctx, g):
        flat, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = bf16_mm(g2, weight).reshape(*g.shape[:-1], weight.shape[1])
        dw = bf16_mm(g2.t(), flat)
        db = g2.sum(dim=0) if ctx.has_bias else None
        return dx, dw, db


def dense_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``F.linear`` at the current precision."""
    if _current.get() == BFLOAT16:
        return _BF16Linear.apply(x, weight, bias)
    return F.linear(x, weight, bias)
