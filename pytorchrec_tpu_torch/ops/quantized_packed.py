"""Packed byte-row layout of quantized embedding tables, and their
row-sparse update (port of ``pytorchrec_tpu/ops/quantized_packed.py``).

One uint8 row holds everything the quantized table keeps per id:

    [0, qb)             q bytes (qb = E for int8, E/2 nibble-packed int4)
    [qb, qb+4G)         per-row scale f32 (G column groups), bit view
    [qb+4G, qb+4G+4)    rowwise-Adagrad accumulator f32, bit view
    [base, base+4E)     f32 row-grad staging (used by training)
    [base+4E, W)        zero pad to the 64-column multiple

f32 fields are bit views, never converted, so a leaf written by the JAX
package reads back bit for bit. The update (``packed_quantized_update``)
moves each touched row three times, as the f32 packed update does: the
forward gather, one permute that carries the staged grads along, one
scatter.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from pytorchrec_tpu_torch.ops.kernels.quantize import (
    dequantize_rows,
    id_keyed_rounding_bits,
    requantize_rows,
    requantize_rows_chain,
)
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
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


def unpack_quantized_table(packed: torch.Tensor, emb_dim: int, bits: int = 8,
                           col_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[V, W] u8 -> (q [V, qb] int8, scale [V] or [V, G] f32, acc [V] f32),
    the inverse of ``pack_quantized_table``."""
    qb = q_row_bytes(emb_dim, bits)
    sb = qb + 4 * col_groups
    q = packed[:, :qb].contiguous().view(torch.int8)
    scale = bytes_to_f32(packed[:, qb:sb])
    acc = bytes_to_f32(packed[:, sb:sb + 4])[:, 0]
    return q, scale[:, 0] if col_groups == 1 else scale, acc


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


def packed_quantized_update(
    packed: torch.Tensor,     # [V, W] u8 (pack_quantized_table)
    rows: torch.Tensor,       # [n, W] the forward gather of packed at ids
    ids: torch.Tensor,        # [n] int32 per-occurrence ids (duplicates allowed)
    dvec: torch.Tensor,       # [n, E] per-occurrence f32 row grads
    rng_bits: Optional[torch.Tensor],  # [n, E] stochastic-rounding bits, or None
    lr: float,
    bits: int = 8,
    col_groups: int = 1,
    eps: float = 1e-6,
    rng_salt: Union[int, torch.Tensor, None] = None,  # uint32 or its word: id-keyed bits
    ids_offset: int = 0,      # local id -> global id shift for the bit keying
) -> torch.Tensor:
    """Rowwise Adagrad and stochastic requantization of the touched packed
    byte rows, in place; returns ``packed``.

    Same passes and arithmetic as the JAX function: stage each occurrence's
    grad bytes in the row's staging columns, permute the rows into id order
    with one stable sort, sum duplicate ids' grads with the segmented scan,
    run rowwise Adagrad and the requantization on every row, and scatter-set
    each segment's last row into the table (other slots route to
    ``V + slot`` and drop). ``rows`` must be the pre-update gather.

    Rounding bits: positional ``rng_bits``, taken in id-sorted slot order,
    or ``rng_salt``, from which the bits derive as
    ``id_keyed_rounding_bits(sorted ids + ids_offset, E, salt)``: a uint32,
    or its device word (a slot of the trainer's step scalars, which a CUDA
    graph reads at each replay; ``ops/kernels/quantize.py::salt_word``).

    Kernels: on the card the scan and the scatter always launch their
    kernels. The requantization launches ``requantize_rows`` for the format
    it computes, int8 with one scale a row and salted bits, as the JAX
    package's kernel does; int4, several column groups and positional bits
    run the same arithmetic as torch operations
    (``requantize_rows_chain``), on the card as on the CPU, since no TPU
    kernel covers them.

    The JAX function returns a new table; the port writes into ``packed``
    itself, so the trainer's buffer is never reallocated."""
    n, e = dvec.shape
    w = packed.shape[1]
    base = packed_q_base(e, bits, col_groups)
    if w < base + 4 * e:
        raise ValueError(f"packed width {w} < {base} q||scale||acc bytes + {4 * e} staging bytes")
    if rng_bits is not None and rng_salt is not None:
        raise ValueError("pass rng_bits or rng_salt, not both")
    if n == 0:
        return packed

    sorted_ids, order = torch.sort(ids, stable=True)
    staged = torch.cat([rows[:, :base], f32_to_bytes(dvec.to(torch.float32)),
                        rows.new_zeros((n, w - base - 4 * e))], dim=1)
    moved = staged.index_select(0, order)
    differs = sorted_ids[1:] != sorted_ids[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=ids.device)
    is_start = torch.cat([one, differs])
    is_last = torch.cat([differs, one])
    if base % 4 == 0 and w % 4 == 0:
        # the staging columns as a strided f32 view of the rows: no copy
        grads = moved.view(torch.float32)[:, base // 4:base // 4 + e]
    else:
        grads = bytes_to_f32(moved[:, base:base + 4 * e])
    g = segmented_sum_scan(grads, is_start)

    global_ids = sorted_ids.to(torch.int64) + ids_offset
    if bits == 8 and col_groups == 1 and rng_salt is not None:
        out = requantize_rows(moved, g, global_ids.to(torch.int32), rng_salt, lr, e, eps)
    else:
        if rng_salt is not None:
            rng_bits = id_keyed_rounding_bits(global_ids, e, rng_salt)
        out = requantize_rows_chain(moved, g, rng_bits, lr, e, eps, bits, col_groups)
    slot = torch.arange(n, dtype=torch.int64, device=ids.device)
    safe_ids = torch.where(is_last, sorted_ids.to(torch.int64), packed.shape[0] + slot)
    return scatter_set_rows(packed, out, safe_ids.to(torch.int32))
