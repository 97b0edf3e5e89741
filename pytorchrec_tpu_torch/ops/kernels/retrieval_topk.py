"""Fused retrieval score + bin max: CUDA kernel, plain version and wrapper.

Replaces ``pytorchrec_tpu/ops/kernels/retrieval_topk.py::_bin_max_kernel``
(the ``pl.pallas_call`` of ``bin_max_scores_pallas``), the candidate step of
two-tower full-corpus retrieval (``serving/retrieval.py``). For queries
``[B, D]`` and a corpus ``items [V, D]`` (bf16 or f32), the queries are cast
to the items' dtype and scored in it with f32 sums; the corpus is cut into
super-chunks of ``tc * group`` rows, and bin ``l`` of super-chunk ``s`` keeps
the largest score over the ids ``s * tc * group + t * 128 + l`` and the id
that scored it (the lowest among equal scores). Ids ``>= V`` score
``PAD_SCORE``, so a bin with no valid id holds its lowest pad id. The result
is ``(vals [B, n_super * 128] f32, idx [B, n_super * 128] int32)``,
``n_super = ceil(V / (tc * group))``: the candidates an exact top-k then
ranks. Expected recall at k over ``n_bins`` bins is about
``1 - (k - 1) / (2 n_bins)``.

The kernel (``csrc/retrieval_topk.cu``) never writes the ``[B, V]`` score
matrix: each (query, bin) pair's running max and tile number stay with the
one thread that owns the pair while a super-chunk's 128-row item tiles go
by. bf16 items run ``wgmma`` fed by TMA in persistent, warp-specialised
blocks; f32 items run f32 FMA in the plain version's order (no TF32, as the
JAX reference on the CPU). It is bound by operations: 1.049 TFLOP at 4096
queries x 1M items x D=128, 1.06 ms in bf16 on the H100, 15.65 ms in f32.
The depth is limited by shared memory (``D <= 256`` bf16, ``D <= 152`` f32
on the H100) and ids are int32; the wrapper raises beyond either before the
launch. TMA needs bf16 rows of a multiple of 8 columns on 16-byte aligned
storage, so the wrapper zero-pads a bf16 depth that is not one in a copy
(zeros add nothing to a score) and copies a misaligned view.

The JAX function's ``tb`` (query rows a TPU grid step) is a tiling choice
that does not change the result; the port has no such argument.

Dispatch by device (``ops/kernels/__init__.py``): a CUDA tensor launches the
kernel and raises if the launch fails; a CPU tensor runs the plain version.
``bin_max_scores.launches`` counts launches; an empty batch or corpus
launches nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from pytorchrec_tpu_torch.ops.kernels import launches_kernel
from pytorchrec_tpu_torch.ops.kernels.build import library

LANES = 128
DEFAULT_TC = 2048  # corpus rows a chunk
DEFAULT_GROUP = 16  # chunks a super-chunk
PAD_SCORE = -1e30  # what a corpus-tail pad id scores (never wins a bin with a valid id)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's codes
_INT32_LIMIT = 2**31


def _check(queries: torch.Tensor, items: torch.Tensor, tc: int, group: int) -> None:
    """The checks both versions share, so the CPU raises where the card
    would."""
    if queries.dim() != 2 or items.dim() != 2 or queries.shape[1] != items.shape[1]:
        raise ValueError(f"want queries [B, D] and items [V, D]; got {tuple(queries.shape)}, "
                         f"{tuple(items.shape)}")
    if items.dtype not in _DTYPES:
        raise TypeError(f"bin_max_scores takes bf16 or f32 items, got {items.dtype}")
    if not queries.is_floating_point():
        raise TypeError(f"queries must be floating point, got {queries.dtype}")
    if tc < LANES or tc % LANES or group < 1:
        raise ValueError(f"tc must be a positive multiple of {LANES} and group >= 1; got tc={tc}, "
                         f"group={group}")
    sup = tc * group
    v = items.shape[0]
    if -(-v // sup) * sup >= _INT32_LIMIT:
        raise ValueError(f"V={v} padded to super-chunks of {sup} rows exceeds the int32 ids")
    if queries.device != items.device:
        raise ValueError(f"queries are on {queries.device}, items on {items.device}")


# elements of the [B, C] block of partial sums ``ordered_scores`` keeps
ORDERED_BLOCK = 1 << 22


def ordered_scores(queries: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """``queries [B, D] @ items [V, D].T`` in f32, each score summed over D
    in order, ``(((q_0 x_0) + q_1 x_1) + ...)``, every product and sum
    rounded: every item takes the same operations wherever it sits, so equal
    item rows score equal bits and ``argmax`` takes the lower id among them.
    A library GEMM need not: the CPU's gives identical rows at different
    columns different last bits. Both sides are upcast to f32 (the products
    of bf16 values are exact in f32). Items go by in blocks of
    ``ORDERED_BLOCK // B`` rows."""
    q = queries.float()
    b, d = q.shape
    v = items.shape[0]
    out = torch.zeros((b, v), dtype=torch.float32, device=items.device)
    cols = max(1, ORDERED_BLOCK // max(b, 1))
    for start in range(0, v, cols):
        part = items[start:start + cols].float().T  # [D, C]
        acc = out[:, start:start + cols]
        for k in range(d):
            acc.add_(q[:, k:k + 1] * part[k])
    return out


def bin_max_scores_plain(queries: torch.Tensor, items: torch.Tensor, tc: int = DEFAULT_TC,
                         group: int = DEFAULT_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (the JAX package's ``bin_max_scores_xla``),
    one super-chunk at a time: ``ordered_scores`` of the queries cast to the
    items' dtype, the tail padded with ``PAD_SCORE``, then ``amax`` and
    ``argmax`` (which takes the first maximum) over each bin's
    ``tc * group / 128`` rows."""
    b, v = queries.shape[0], items.shape[0]
    sup = tc * group
    q = queries.to(items.dtype)
    lane = torch.arange(LANES, device=items.device)
    vals, idx = [], []
    for start in range(0, v, sup):
        scores = ordered_scores(q, items[start:start + sup])  # [B, <= sup] f32
        if scores.shape[1] < sup:
            scores = F.pad(scores, (0, sup - scores.shape[1]), value=PAD_SCORE)
        scores = scores.reshape(b, sup // LANES, LANES)
        vals.append(scores.amax(dim=1))
        idx.append((start + scores.argmax(dim=1) * LANES + lane).to(torch.int32))
    if not vals:
        return (torch.empty((b, 0), dtype=torch.float32, device=items.device),
                torch.empty((b, 0), dtype=torch.int32, device=items.device))
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


@functools.cache
def _kernel():
    lib = library("retrieval_topk")
    lib.bin_max_scores_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.bin_max_scores_fwd.restype = ctypes.c_int
    lib.bin_max_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bin_max_smem_bytes.restype = ctypes.c_longlong
    lib.bin_max_error_string.argtypes = [ctypes.c_int]
    lib.bin_max_error_string.restype = ctypes.c_char_p
    return lib


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x [n, D]`` bf16 as TMA reads it: D zero-padded to a multiple of 8
    (a 16-byte row stride) and 16-byte aligned storage, copied only where
    it is not so already."""
    pad = -x.shape[1] % 8
    if pad:
        return F.pad(x, (0, pad))
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(queries: torch.Tensor, items: torch.Tensor, tc: int,
            group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if not items.is_contiguous():
        raise ValueError("bin_max_scores takes a contiguous items tensor")
    b, d = queries.shape
    v = items.shape[0]
    sup = tc * group
    n_super = -(-v // sup)
    vals = torch.empty((b, n_super * LANES), dtype=torch.float32, device=items.device)
    idx = torch.empty((b, n_super * LANES), dtype=torch.int32, device=items.device)
    if b == 0 or v == 0:
        return vals, idx
    if b >= _INT32_LIMIT:
        raise ValueError(f"B={b} exceeds the kernel's int32 counts")
    q = queries.to(items.dtype).contiguous()  # the JAX kernel casts too (retrieval_topk.py:145)
    if items.dtype == torch.bfloat16:
        q, items, d = _tma_ready(q), _tma_ready(items), -(-d // 8) * 8
    lib = _kernel()
    code = _DTYPES[items.dtype]
    smem = lib.bin_max_smem_bytes(d, code)
    limit = torch.cuda.get_device_properties(items.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"bin_max_scores kernel needs {smem} B of shared memory at D={d} "
                         f"({items.dtype}); the device allows {limit} B a block")
    with torch.cuda.device(items.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bin_max_scores_fwd(q.data_ptr(), items.data_ptr(), vals.data_ptr(),
                                     idx.data_ptr(), b, v, d, sup // LANES, n_super, code, stream)
    if err != 0:
        raise RuntimeError("bin_max_scores kernel launch failed: "
                           + lib.bin_max_error_string(err).decode())
    bin_max_scores.launches += 1
    return vals, idx


def bin_max_scores(queries: torch.Tensor, items: torch.Tensor, tc: int = DEFAULT_TC,
                   group: int = DEFAULT_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused score + per-super-chunk bin maxima: ``queries [B, D]`` (any
    float dtype, cast to the items'), ``items [V, D]`` bf16 or f32 ->
    ``(vals [B, n_super * 128] f32, idx [B, n_super * 128] int32)``: the
    candidates' exact scores and corpus ids, 128 bins a super-chunk of
    ``tc * group`` rows."""
    _check(queries, items, tc, group)
    if launches_kernel(queries, items):
        return _launch(queries, items, tc, group)
    return bin_max_scores_plain(queries, items, tc, group)


bin_max_scores.launches = 0
