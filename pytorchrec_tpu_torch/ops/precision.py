"""The train step's matmul precision (the JAX trainer's
``compile(matmul_precision=...)``, which traces its step under
``jax.default_matmul_precision``).

``"bfloat16"`` runs the dense products of a train step, forward and
backward, on bf16-rounded operands with f32 results and f32 accumulation:
on the card one bf16 cuBLAS GEMM with an f32 output (``torch.mm(...,
out_dtype=torch.float32)``), on the CPU its plain emulation (each operand
rounded to bf16 and back, then an f32 product). The products it covers are
the linear layers built by ``ops/mlp.py::linear`` (``dense_linear``), the
GEMMs of ``CrossNetworkFunction``'s backward (``precision_mm``) and the
expert banks' batched products of ``models/multitask.py``
(``expert_product``: one bf16 batched GEMM over the expert axis, forward
and backward); B1's forward kernel stays f32. ``None``, ``"float32"`` and ``"highest"`` are full f32,
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


def bf16_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 3-D f32 tensors (a batch of products) on bf16-rounded
    operands, an f32 result with f32 accumulation."""
    if a.is_cuda:
        return torch.bmm(a.bfloat16(), b.bfloat16(), out_dtype=torch.float32)
    return torch.bmm(a.bfloat16().float(), b.bfloat16().float())


class _BF16ExpertProduct(torch.autograd.Function):
    """``einsum("...kd,kdh->...kh", h, w)`` with every product (the
    backward's two included) a bf16 batched GEMM over the expert axis."""

    @staticmethod
    def forward(ctx, h, w):
        k, d = h.shape[-2:]
        hk = h.reshape(-1, k, d).transpose(0, 1)  # [K, N, D]
        ctx.save_for_backward(hk, w)
        ctx.lead = h.shape[:-2]
        out = bf16_bmm(hk, w)  # [K, N, H]
        return out.transpose(0, 1).reshape(*ctx.lead, k, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        hk, w = ctx.saved_tensors
        k, h = g.shape[-2:]
        gk = g.reshape(-1, k, h).transpose(0, 1)  # [K, N, H]
        dh = bf16_bmm(gk, w.transpose(1, 2))  # [K, N, D]
        dw = bf16_bmm(hk.transpose(1, 2), gk)  # [K, D, H]
        return dh.transpose(0, 1).reshape(*ctx.lead, k, w.shape[1]), dw


def expert_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each expert's product ``[..., K, D] x [K, D, H] -> [..., K, H]`` at
    the current precision: at full f32 one ``torch.einsum`` (a batched
    GEMM over K)."""
    if _current.get() == BFLOAT16:
        return _BF16ExpertProduct.apply(h, w)
    return torch.einsum("...kd,kdh->...kh", h, w)
