"""Packed byte-row layout of quantized embedding tables (port of the
serving parts of ``pytorchrec_tpu/ops/quantized_packed.py``).

One uint8 row holds everything the quantized table keeps per id:

    [0, qb)             q bytes (qb = E for int8, E/2 nibble-packed int4)
    [qb, qb+4G)         per-row scale f32 (G column groups), bit view
    [qb+4G, qb+4G+4)    rowwise-Adagrad accumulator f32, bit view
    [base, base+4E)     f32 row-grad staging (used by training)
    [base+4E, W)        zero pad to the 64-column multiple

f32 fields are bit views, never converted, so a leaf written by the JAX
package reads back bit for bit.
"""

from __future__ import annotations

import torch

from pytorchrec_tpu_torch.ops.kernels.quantize import dequantize_rows
from pytorchrec_tpu_torch.ops.sparse_update import _FAST_WIDTH, bytes_to_f32, f32_to_bytes


def q_row_bytes(emb_dim: int, bits: int) -> int:
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if bits == 4 and emb_dim % 2:
        raise ValueError("int4 packing needs an even emb_dim")
    return emb_dim if bits == 8 else emb_dim // 2


def packed_q_base(emb_dim: int, bits: int, col_groups: int) -> int:
    """Byte offset of the grad-staging region (= bytes of q + scale + acc)."""
    return q_row_bytes(emb_dim, bits) + 4 * col_groups + 4


def packed_q_width(emb_dim: int, bits: int, col_groups: int = 1,
                   min_width: int = _FAST_WIDTH) -> int:
    need = packed_q_base(emb_dim, bits, col_groups) + 4 * emb_dim
    return max(min_width, -(-need // _FAST_WIDTH) * _FAST_WIDTH)


def pack_quantized_table(q: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor,
                         emb_dim: int, bits: int = 8, col_groups: int = 1,
                         min_width: int = _FAST_WIDTH) -> torch.Tensor:
    """(q [V, qb] int8, scale [V] or [V, G] f32, acc [V] f32) -> [V, W] u8."""
    v = q.shape[0]
    scale2 = scale[:, None] if scale.dim() == 1 else scale
    if tuple(scale2.shape) != (v, col_groups):
        raise ValueError(f"scale {tuple(scale.shape)} does not fit {col_groups} groups")
    w = packed_q_width(emb_dim, bits, col_groups, min_width)
    base = packed_q_base(emb_dim, bits, col_groups)
    return torch.cat([
        q.contiguous().view(torch.uint8),
        f32_to_bytes(scale2),
        f32_to_bytes(acc[:, None]),
        torch.zeros((v, w - base), dtype=torch.uint8, device=q.device),
    ], dim=1)


def dequant_packed_rows(rows: torch.Tensor, emb_dim: int, bits: int = 8,
                        col_groups: int = 1) -> torch.Tensor:
    """[n, W] u8 packed rows -> [n, E] f32 dequantized embedding rows."""
    qb = q_row_bytes(emb_dim, bits)
    q = rows[:, :qb].contiguous().view(torch.int8)
    scale = bytes_to_f32(rows[:, qb:qb + 4 * col_groups])
    if col_groups == 1:
        scale = scale[:, 0]
    return dequantize_rows(q, scale, bits=bits, col_groups=col_groups)


def packed_gather_dequant(packed: torch.Tensor, ids: torch.Tensor, emb_dim: int,
                          bits: int = 8, col_groups: int = 1) -> torch.Tensor:
    """``[ids..., E]`` f32 rows gathered from a ``[V, W]`` u8 packed table and
    dequantized."""
    rows = torch.index_select(packed, 0, ids.reshape(-1))
    return dequant_packed_rows(rows, emb_dim, bits, col_groups).reshape(*ids.shape, emb_dim)
