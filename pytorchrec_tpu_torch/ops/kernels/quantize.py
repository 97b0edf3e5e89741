"""Row quantization, f32 rows <-> int8 (or nibble-packed int4) + f32 scale
(port of the plain parts of ``pytorchrec_tpu/ops/kernels/quantize.py``).

Serving reads quantized tables, so this slice needs only the plain torch
functions: int4 packing, round-to-nearest quantization (table init) and
dequantization. The TPU kernels of that module, ``quantize_rows_pallas``
(stochastic rounding) and ``requantize_rows_pallas`` (the int8 table
update), are ported with the training slices.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., E] int8 values in [-7, 7] -> [..., E//2] packed bytes (even
    columns in the low nibble, odd in the high)."""
    v = q.to(torch.int32)
    low = v[..., 0::2] & 0xF
    high = (v[..., 1::2] & 0xF) << 4
    return (low | high).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., E//2] packed bytes -> [..., E] int8 values in [-8, 7]
    (two's-complement nibble sign-extension via the xor-8 trick)."""
    p = packed.to(torch.int32) & 0xFF
    low = ((p & 0xF) ^ 8) - 8
    high = (((p >> 4) & 0xF) ^ 8) - 8
    out = torch.stack([low, high], dim=-1)
    return out.reshape(*packed.shape[:-1], -1).to(torch.int8)


def quantize_rows(rows: torch.Tensor, bits: int = 8,
                  col_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-to-nearest quantization: [N, E] f32 -> ([N, E] int8 (bits=8) or
    [N, E//2] packed (bits=4), f32 scale [N] or [N, G]).

    ``col_groups=G`` gives each row G column groups with an absmax scale of
    their own. Ties round to even, as ``jnp.rint`` does."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    n, e = rows.shape
    if e % col_groups:
        raise ValueError(f"E={e} does not split into {col_groups} column groups")
    if bits == 4 and (e // col_groups) % 2:
        raise ValueError("int4 groups must pack to whole bytes")
    qmax = 127.0 if bits == 8 else 7.0
    grouped = rows.reshape(n, col_groups, e // col_groups)
    absmax = grouped.abs().amax(dim=-1)                       # [N, G]
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.round((grouped / scale[..., None]).reshape(n, e))
    q = q.clamp(-qmax, qmax).to(torch.int8)
    if col_groups == 1:
        scale = scale[:, 0]
    if bits == 4:
        return pack_int4(q), scale
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, bits: int = 8,
                    col_groups: int = 1) -> torch.Tensor:
    """([..., E] int8 or [..., E//2] packed int4, [...] or [..., G] f32)
    -> [..., E] f32. ``col_groups`` must match the quantization call."""
    if bits == 4:
        q = unpack_int4(q)
    if col_groups == 1:
        return q.to(torch.float32) * scale[..., None]
    e = q.shape[-1]
    per_col = torch.repeat_interleave(scale, e // col_groups, dim=-1)  # [..., E]
    return q.to(torch.float32) * per_col
