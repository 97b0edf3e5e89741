"""FM second-order interaction: CUDA kernels, plain versions and wrappers.

Replaces ``pytorchrec_tpu/ops/kernels/fm.py``: ``_fm_fwd_kernel`` and
``_fm_bwd_kernel``, the two ``pl.pallas_call``s of ``fm_interaction_pallas``.
For field vectors ``v [B, F, E]`` f32:

* ``fm_interaction(v) -> [B]``: ``0.5 * sum_e[(sum_f v)^2 - sum_f v^2]``;
* ``fm_interaction_backward(v, g) -> [B, F, E]``: ``g * (sum_f v - v)``, the
  gradient for the upstream gradient ``g [B]``.

The kernels (``csrc/fm.cu``) give a row to a few lanes of a warp (two rows a
warp at E=16), keep each column's sum and sum of squares in registers and
reduce the row with shuffles; the backward recomputes the column sums. Both
are bound by bytes: at the training batch ``[32768, 39, 16]`` the forward
reads 81.8 MB (0.024 ms on the H100), the backward reads and writes 163.6 MB
(0.049 ms).

Dispatch by device (``ops/kernels/__init__.py``): a CUDA tensor launches the
kernel and raises if the launch fails; a CPU tensor runs the plain version.
The forward is the op ``torch.ops.pytorchrec.fm_interaction``, which
``torch.export`` keeps in its graph.
``fm_interaction.launches`` and ``fm_interaction_backward.launches`` count
kernel launches; an empty input launches nothing.

Gradient. When grad mode is on and ``v`` requires grad, the forward runs
inside ``FMInteractionFunction``, which keeps ``v`` for the backward (the
Pallas ``custom_vjp`` keeps it as its residual) and whose backward is
``fm_interaction_backward``: the second kernel on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pytorchrec_tpu_torch.ops.kernels import count_launch, define_op, launches_kernel
from pytorchrec_tpu_torch.ops.kernels.build import library


def fm_interaction_plain(v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the sum/square/reduce chain of the JAX
    package's ``fm_interaction``."""
    sum_of_fields = v.sum(dim=1)
    sum_of_squares = torch.square(v).sum(dim=1)
    return 0.5 * (torch.square(sum_of_fields) - sum_of_squares).sum(dim=-1)


def fm_interaction_backward_plain(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the closed-form gradient ``g * (sum_f v - v)``."""
    return g[:, None, None] * (v.sum(dim=1, keepdim=True) - v)


@functools.cache
def _kernel():
    lib = library("fm")
    lib.fm_fwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.fm_fwd.restype = ctypes.c_int
    lib.fm_bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.fm_bwd.restype = ctypes.c_int
    lib.fm_error_string.argtypes = [ctypes.c_int]
    lib.fm_error_string.restype = ctypes.c_char_p
    return lib


def _check(v: torch.Tensor, g=None) -> None:
    """The checks both versions share: the kernels' operands, so the CPU
    raises where the card would."""
    if v.dim() != 3:
        raise ValueError(f"want field vectors [B, F, E]; got {tuple(v.shape)}")
    tensors = (("v", v),) if g is None else (("v", v), ("g", g))
    if g is not None and tuple(g.shape) != (v.shape[0],):
        raise ValueError(f"want g [{v.shape[0]}] for v {tuple(v.shape)}; got {tuple(g.shape)}")
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"fm_interaction takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fm_interaction takes contiguous tensors; {name} is not")
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
    batch, fields, emb = v.shape
    if batch >= 2**31 or fields * emb >= 2**31:
        raise ValueError(f"shape {tuple(v.shape)} exceeds the kernel's int32 indexing")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _kernel().fm_error_string(err).decode())


def _launch_forward(v: torch.Tensor) -> torch.Tensor:
    batch, fields, emb = v.shape
    if v.numel() == 0:
        return v.new_zeros((batch,))
    out = torch.empty((batch,), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel().fm_fwd(v.data_ptr(), out.data_ptr(), batch, fields, emb, stream)
    _raise_on(err, "fm_fwd")
    count_launch(fm_interaction)
    return out


FM_OP = define_op("fm_interaction", _launch_forward, fm_interaction_plain,
                  lambda v: v.new_empty((v.shape[0],)))


def _forward(v: torch.Tensor) -> torch.Tensor:
    return FM_OP(v)


def _launch_backward(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    dv = torch.empty_like(v)
    if v.numel() == 0:
        return dv
    batch, fields, emb = v.shape
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel().fm_bwd(v.data_ptr(), g.data_ptr(), dv.data_ptr(), batch, fields, emb,
                               stream)
    _raise_on(err, "fm_bwd")
    count_launch(fm_interaction_backward)
    return dv


def fm_interaction_backward(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dv [B, F, E] = g * (sum_f v - v)`` for ``v [B, F, E]`` and the
    upstream gradient ``g [B]``, both f32 and contiguous."""
    _check(v, g)
    if launches_kernel(v, g):
        return _launch_backward(v, g)
    return fm_interaction_backward_plain(v, g)


class FMInteractionFunction(torch.autograd.Function):
    """The forward kernel (or, on the CPU, the plain version), with ``v``
    kept for the backward kernel."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return _forward(v)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return fm_interaction_backward(v, g.contiguous())


def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """FM second-order term: ``v [B, F, E]`` f32, contiguous -> ``[B]``. The
    result carries a gradient when grad mode is on and ``v`` requires one."""
    _check(v)
    if torch.is_grad_enabled() and v.requires_grad:
        return FMInteractionFunction.apply(v)
    return _forward(v)


fm_interaction.launches = 0
fm_interaction_backward.launches = 0
