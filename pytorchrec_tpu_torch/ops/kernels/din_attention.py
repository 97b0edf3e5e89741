"""DIN attention pooling: CUDA kernel, plain version and wrapper.

Replaces ``pytorchrec_tpu/ops/kernels/din_attention.py::_make_din_kernel``
(the ``pl.pallas_call`` of ``din_attention_pool_pallas``). For a history
``his [B, S, E]``, candidates ``tgt [B, N, E]``, a mask ``valid [B, S]`` int32
(nonzero = valid) and the score MLP ``params = (w_0, b_0, ..., w_k, b_k)``
(flax's ``[in, out]`` kernels, ``w_0 [4E, H_1]``, the head ``w_k [H_k, 1]``),
``din_attention_pool`` returns ``[B, N, E]``: each candidate's softmax over S
of the MLP's scores of ``[h, t, h - t, h * t]`` (invalid steps at -inf),
weighting the history rows. A row with no valid step gives NaN, as in JAX.

The kernel (``csrc/din_attention.cu``) keeps the weights in shared memory
for the whole launch and runs every (candidate, step) pair of a tile of rows
through the MLP, the softmax and the pooling without writing anything but the
result. It is bound by operations. Since ``[h, t, h - t, h * t] w_0 =
h (w_a + w_c) + t (w_b - w_c) + (h * t) w_d`` (``w_0``'s four row blocks),
the kernel runs this split form: it forms the three blocks in f32 as it
loads them, the t part once a (b, n) row of a tile, and for each pair
``h (w_a + w_c) + (h * t) w_d``: 4.6 GFLOP at the training step's
``[4096, 2, 20]`` with E=64 and hidden (80, 40), where the concat form is
7.8. The least work also runs the h part once a (b, s) across the
candidates: 3.7 GFLOP there, 0.055 ms on the H100. Left open: that h part,
the lanes idle where a layer's width is not a multiple of 32, and tensor
cores. A layer may be as wide as the device's shared memory allows.

The activation (``"sigmoid"`` or ``"relu"``) is an argument of the kernel as
of the plain version. The JAX kernel ignores it and always applies sigmoid,
while the JAX package's XLA path (the CPU reference) honours it; the port
follows the XLA path. The JAX package also turns its kernel off for N > 16
and pads the batch to its block: TPU constraints, not carried over. On the
card every call launches the kernel, at any N, with no padding.

Dispatch by device (``ops/kernels/__init__.py``): a CUDA tensor launches the
kernel and raises if the launch fails; a CPU tensor runs the plain version.
``din_attention_pool.launches`` counts launches; an empty batch launches
nothing.

Gradient. When grad mode is on and an input requires grad, the forward runs
inside ``DINAttentionFunction``, whose backward is the JAX package's
``custom_vjp`` rule: recompute the plain composite under autograd and take
its gradient for ``his``, ``tgt`` and every weight and bias (``valid`` gets
none). The JAX package has no backward kernel, so neither has the port.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from pytorchrec_tpu_torch.ops.kernels import launches_kernel
from pytorchrec_tpu_torch.ops.kernels.build import library

ACTIVATIONS = {"sigmoid": 0, "relu": 1}  # the kernel's codes
CHUNK = 128  # (n, s) pairs a block runs through the MLP at once: 16 warps of 8
MAX_HIDDEN, MAX_STEPS = 7, 8192


def din_attention_pool_plain(his: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                             params: Sequence[torch.Tensor],
                             activation: str = "sigmoid") -> torch.Tensor:
    """The plain PyTorch version: the JAX package's XLA composite, with the
    ``[B, N, S, 4E]`` feature tensor, the score MLP, -inf masking, a softmax
    over S and ``einsum("bns,bse->bne")``."""
    act = torch.sigmoid if activation == "sigmoid" else torch.relu
    b, s, e = his.shape
    n = tgt.shape[1]
    his_b = his[:, None, :, :].expand(b, n, s, e)
    tgt_b = tgt[:, :, None, :].expand(b, n, s, e)
    a = torch.cat([his_b, tgt_b, his_b - tgt_b, his_b * tgt_b], dim=-1)
    for i in range(len(params) // 2 - 1):
        a = act(a @ params[2 * i] + params[2 * i + 1])
    scores = (a @ params[-2] + params[-1])[..., 0]
    scores = scores.masked_fill(valid[:, None, :] == 0, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bns,bse->bne", weights, his)


@functools.cache
def _kernel():
    lib = library("din_attention")
    lib.din_attention_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
                                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.din_attention_fwd.restype = ctypes.c_int
    lib.din_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_int]
    lib.din_attention_smem_bytes.restype = ctypes.c_longlong
    lib.din_attention_error_string.argtypes = [ctypes.c_int]
    lib.din_attention_error_string.restype = ctypes.c_char_p
    return lib


class TilePlan(NamedTuple):
    rows: int  # (b, n) rows a tile
    smem_bytes: int  # shared memory a block


def smem_bytes(e: int, s: int, hidden: Sequence[int], rows: int) -> int:
    """The shared memory a block of the kernel takes at width E=``e``, S=``s``
    steps, the score MLP's ``hidden`` widths and ``rows`` (b, n) rows a tile,
    as ``plan`` in ``csrc/din_attention.cu`` lays it out: the weights (``w_0``
    as three ``[E, H_1]`` blocks) padded to 16 bytes, a chunk's history rows,
    the tile's candidate rows and t parts, two activation buffers and the
    tile's scores."""
    dims = [4 * e, *hidden, 1]
    weights = 3 * e * dims[1] + sum(dims[i] * dims[i + 1] for i in range(1, len(dims) - 1))
    weights = -(-(weights + sum(dims[1:])) // 4) * 4
    return 4 * (weights + CHUNK * e + rows * (e + dims[1]) + 2 * CHUNK * max(hidden) + rows * s)


def tile_plan(e: int, s: int, hidden: Sequence[int], limit: int) -> TilePlan:
    """The kernel's tile at width E=``e``, S=``s`` steps and the score MLP's
    ``hidden`` widths, on a device that allows ``limit`` bytes of shared
    memory a block: as many whole (b, n) rows as fill a chunk, at least one,
    and fewer where a block of that many would not fit (each row holds its
    candidate, its t part and its scores, so a wide first layer at a small S
    takes fewer rows). Raises ``ValueError`` outside the kernel's limits."""
    if not 1 <= len(hidden) <= MAX_HIDDEN or not 1 <= s <= MAX_STEPS:
        raise ValueError(f"din_attention_pool kernel takes 1 to {MAX_HIDDEN} hidden layers and "
                         f"1 <= S <= {MAX_STEPS}; got widths {list(hidden)}, S={s}")
    per_row = smem_bytes(e, s, hidden, 1) - smem_bytes(e, s, hidden, 0)
    fit = (limit - smem_bytes(e, s, hidden, 0)) // per_row
    rows = min(CHUNK // s if s < CHUNK else 1, fit)
    if rows < 1:
        raise ValueError(f"din_attention_pool kernel needs {smem_bytes(e, s, hidden, 1)} B of "
                         f"shared memory at E={e}, S={s}, widths {list(hidden)} with one row a "
                         f"tile; the device allows {limit} B a block")
    return TilePlan(rows, smem_bytes(e, s, hidden, rows))


def _check(his, tgt, valid, params, activation) -> None:
    """The checks both versions share: the kernel's operands, so the CPU
    raises where the card would."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, got {activation!r}")
    if his.dim() != 3 or tgt.dim() != 3 or valid.dim() != 2:
        raise ValueError(f"want his [B, S, E], tgt [B, N, E], valid [B, S]; got "
                         f"{tuple(his.shape)}, {tuple(tgt.shape)}, {tuple(valid.shape)}")
    b, s, e = his.shape
    if tgt.shape[0] != b or tgt.shape[2] != e or tuple(valid.shape) != (b, s):
        raise ValueError(f"tgt {tuple(tgt.shape)} / valid {tuple(valid.shape)} do not fit his "
                         f"{tuple(his.shape)}")
    if s < 1 or e < 1:
        raise ValueError(f"want at least one step and one column; his is {tuple(his.shape)}")
    if len(params) % 2 or len(params) < 4:
        raise ValueError(f"want (w_0, b_0, ..., w_k, b_k) with at least one hidden layer; got "
                         f"{len(params)} tensors")
    width = 4 * e
    for i in range(0, len(params), 2):
        w, bias = params[i], params[i + 1]
        out = 1 if i == len(params) - 2 else w.shape[-1]
        if tuple(w.shape) != (width, out) or tuple(bias.shape) != (out,):
            raise ValueError(f"layer {i // 2}: w {tuple(w.shape)}, b {tuple(bias.shape)}; want "
                             f"[{width}, {out}] and [{out}]")
        width = out
    if valid.dtype != torch.int32:
        raise TypeError(f"valid must be int32, got {valid.dtype}")
    named = [("his", his), ("tgt", tgt), ("valid", valid)]
    named += [(f"params[{i}]", p) for i, p in enumerate(params)]
    for name, t in named:
        if name != "valid" and t.dtype != torch.float32:
            raise TypeError(f"din_attention_pool takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"din_attention_pool takes contiguous tensors; {name} is not")
        if t.device != his.device:
            raise ValueError(f"{name} is on {t.device}, his on {his.device}")


def _launch(his, tgt, valid, params, activation) -> torch.Tensor:
    b, s, e = his.shape
    n = tgt.shape[1]
    out = torch.empty((b, n, e), dtype=torch.float32, device=his.device)
    if out.numel() == 0:
        return out
    if b >= 2**31 or n >= 2**31:
        raise ValueError(f"B={b}, N={n} exceed the kernel's int32 counts")
    layers = len(params) // 2
    dims = (ctypes.c_int * (layers + 1))(*[p.shape[0] for p in params[0::2]], 1)
    limit = torch.cuda.get_device_properties(his.device).shared_memory_per_block_optin
    plan = tile_plan(e, s, list(dims)[1:-1], limit)
    lib = _kernel()
    weights = (ctypes.c_void_p * layers)(*[p.data_ptr() for p in params[0::2]])
    biases = (ctypes.c_void_p * layers)(*[p.data_ptr() for p in params[1::2]])
    with torch.cuda.device(his.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.din_attention_fwd(his.data_ptr(), tgt.data_ptr(), valid.data_ptr(), weights,
                                    biases, dims, layers, out.data_ptr(), b, n, s, e,
                                    ACTIVATIONS[activation], plan.rows, stream)
    if err != 0:
        raise RuntimeError("din_attention_pool kernel launch failed: "
                           + lib.din_attention_error_string(err).decode())
    din_attention_pool.launches += 1
    return out


def _forward(his, tgt, valid, params, activation) -> torch.Tensor:
    if launches_kernel(his, tgt, valid, *params):
        return _launch(his, tgt, valid, params, activation)
    return din_attention_pool_plain(his, tgt, valid, params, activation)


class DINAttentionFunction(torch.autograd.Function):
    """The kernel forward (or, on the CPU, the plain version) with the JAX
    package's backward: autograd through the recomputed plain composite."""

    @staticmethod
    def forward(ctx, his, tgt, valid, activation, *params):
        ctx.activation = activation
        ctx.save_for_backward(his, tgt, valid, *params)
        return _forward(his, tgt, valid, params, activation)

    @staticmethod
    def backward(ctx, g):
        his, tgt, valid, *params = ctx.saved_tensors
        needs = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], *ctx.needs_input_grad[4:]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip((his, tgt, *params), needs)]
            out = din_attention_pool_plain(leaves[0], leaves[1], valid, leaves[2:],
                                           ctx.activation)
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], g))
        full = [next(grads) if need else None for need in needs]
        return (full[0], full[1], None, None, *full[2:])


def din_attention_pool(his: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                       params: Sequence[torch.Tensor], activation: str = "sigmoid") -> torch.Tensor:
    """Fused DIN attention pooling: ``his [B, S, E]``, ``tgt [B, N, E]``,
    ``valid [B, S]`` int32, ``params = (w_0, b_0, ..., w_k, b_k)``, all
    contiguous -> ``[B, N, E]``. The result carries a gradient when grad mode
    is on and an input requires one."""
    params = tuple(params)
    _check(his, tgt, valid, params, activation)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (his, tgt, *params)):
        return DINAttentionFunction.apply(his, tgt, valid, activation, *params)
    return _forward(his, tgt, valid, params, activation)


din_attention_pool.launches = 0
