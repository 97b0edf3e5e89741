"""Fused DCN-v2 cross network: CUDA kernel, plain version and wrapper.

Replaces ``pytorchrec_tpu/ops/kernels/cross.py::_cross_fwd_kernel`` (the
``pl.pallas_call`` of ``cross_network_pallas``). For ``x0 [B, D]``,
``ws [L, D, D]`` (``x @ W`` orientation) and ``bs [L, D]`` it computes all L
layers ``x_{l+1} = x0 * (x_l @ W_l + b_l) + x_l`` and returns ``x_L``.

The kernel (``csrc/cross.cu``) keeps each block's rows of ``x_l`` in shared
memory across all layers and streams ``W_l`` from L2 in tiles, so ``x_l``
makes no round trip through device memory between layers. It takes
D <= 512. It is bound by operations: ``2*B*D^2*L`` f32 FMA-operations,
0.54 ms on the H100 at the main-path shape (B=32768, D=429, L=3) against
0.034 ms of memory.

``cross_network`` dispatches by device (``ops/kernels/__init__.py``): a CUDA
tensor launches the kernel and raises if the launch fails; a CPU tensor runs
``cross_network_plain``. ``cross_network.launches`` counts kernel launches.

Gradient. When grad mode is on and an input requires grad, the forward runs
inside ``CrossNetworkFunction`` (a ``torch.autograd.Function``), whose
backward is the JAX package's custom-VJP formula
(``pytorchrec_tpu/ops/kernels/cross.py`` ``bwd``) in plain torch: the layer
inputs are recomputed, then the layers are walked back. The JAX package has
no backward kernel either (XLA runs it), so its products go to
``torch.mm``/``torch.addmm``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pytorchrec_tpu_torch.ops.kernels import launches_kernel
from pytorchrec_tpu_torch.ops.kernels.build import library


def cross_network_plain(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: one matmul and one Hadamard per layer."""
    xl = x0
    for layer in range(ws.shape[0]):
        xl = x0 * (xl @ ws[layer] + bs[layer]) + xl
    return xl


@functools.cache
def _kernel():
    lib = library("cross")
    lib.cross_network_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.cross_network_fwd.restype = ctypes.c_int
    lib.cross_network_max_width.argtypes = []
    lib.cross_network_max_width.restype = ctypes.c_int
    lib.cross_network_smem_bytes.argtypes = [ctypes.c_int]
    lib.cross_network_smem_bytes.restype = ctypes.c_longlong
    lib.cross_network_error_string.argtypes = [ctypes.c_int]
    lib.cross_network_error_string.restype = ctypes.c_char_p
    return lib


def _check(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> None:
    if x0.dim() != 2 or ws.dim() != 3 or bs.dim() != 2:
        raise ValueError(f"want x0 [B, D], ws [L, D, D], bs [L, D]; got "
                         f"{tuple(x0.shape)}, {tuple(ws.shape)}, {tuple(bs.shape)}")
    num_layers, d = ws.shape[0], x0.shape[1]
    if tuple(ws.shape) != (num_layers, d, d) or tuple(bs.shape) != (num_layers, d):
        raise ValueError(f"ws {tuple(ws.shape)} / bs {tuple(bs.shape)} do not fit D={d}")


def _launch(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    for name, t in (("x0", x0), ("ws", ws), ("bs", bs)):
        if t.dtype != torch.float32:
            raise TypeError(f"cross_network kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cross_network kernel takes contiguous tensors; {name} is not")
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
    batch, d = x0.shape
    if batch >= 2**31 or d >= 2**31:
        raise ValueError(f"shape {tuple(x0.shape)} exceeds the kernel's int32 indexing")
    lib = _kernel()
    if d > lib.cross_network_max_width():
        raise ValueError(f"cross_network kernel takes D <= {lib.cross_network_max_width()}, "
                         f"got D={d}")
    smem = lib.cross_network_smem_bytes(d)
    limit = torch.cuda.get_device_properties(x0.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"cross_network kernel needs {smem} B of shared memory at D={d}; "
                         f"the device allows {limit} B a block")
    out = torch.empty_like(x0)
    if batch == 0:
        return out
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cross_network_fwd(x0.data_ptr(), ws.data_ptr(), bs.data_ptr(), out.data_ptr(),
                                    batch, d, ws.shape[0], stream)
    if err != 0:
        raise RuntimeError("cross_network kernel launch failed: "
                           + lib.cross_network_error_string(err).decode())
    cross_network.launches += 1
    return out


def _forward(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    if launches_kernel(x0, ws, bs):
        return _launch(x0, ws, bs)
    return cross_network_plain(x0, ws, bs)


def cross_network_backward(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
                           g: torch.Tensor):
    """``(dx0, dws, dbs)`` for the upstream gradient ``g = dL/dx_L``.

    With ``u_l = x_l W_l + b_l``: ``dW_l = x_l^T (g_l * x0)``,
    ``db_l = sum_rows(g_l * x0)``, ``dx0 += g_l * u_l`` and
    ``g_{l-1} = (g_l * x0) W_l^T + g_l``; ``x_0`` is ``x0``, so the walked-back
    ``g`` lands on ``dx0`` at the end. ``u_l`` is kept from the recompute, so
    the backward runs 3 products a layer."""
    xs, us = [], []
    xl = x0
    for layer in range(ws.shape[0]):
        u = torch.addmm(bs[layer], xl, ws[layer])
        xs.append(xl)
        us.append(u)
        xl = x0 * u + xl
    dx0 = torch.zeros_like(x0)
    dws, dbs = [None] * len(xs), [None] * len(xs)
    for layer in reversed(range(len(xs))):
        gx0 = g * x0
        dws[layer] = torch.mm(xs[layer].t(), gx0)
        dbs[layer] = gx0.sum(dim=0)
        dx0 = dx0 + g * us[layer]
        g = torch.mm(gx0, ws[layer].t()) + g
    return dx0 + g, torch.stack(dws), torch.stack(dbs)


class CrossNetworkFunction(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward with the
    closed-form backward of ``cross_network_backward``."""

    @staticmethod
    def forward(ctx, x0, ws, bs):
        ctx.save_for_backward(x0, ws, bs)
        return _forward(x0, ws, bs)

    @staticmethod
    def backward(ctx, g):
        x0, ws, bs = ctx.saved_tensors
        return cross_network_backward(x0, ws, bs, g.contiguous())


def cross_network(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """Fused cross network: ``x0 [B, D]``, ``ws [L, D, D]``, ``bs [L, D]`` ->
    ``x_L [B, D]``. ``L == 0`` is the identity and launches nothing. The
    result carries a gradient when grad mode is on and an input requires
    one."""
    _check(x0, ws, bs)
    if ws.shape[0] == 0:
        return x0
    if torch.is_grad_enabled() and (x0.requires_grad or ws.requires_grad or bs.requires_grad):
        return CrossNetworkFunction.apply(x0, ws, bs)
    return _forward(x0, ws, bs)


cross_network.launches = 0
