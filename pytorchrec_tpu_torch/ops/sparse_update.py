"""Packed-row helpers of ``pytorchrec_tpu/ops/sparse_update.py``.

Serving needs only the layout: the byte views of f32 columns and the table
columns of a packed ``table || moments || staging`` row. The row-sparse
updates themselves are ported with the training slices.
"""

from __future__ import annotations

import torch

# Packed rows are padded to a multiple of 64 columns; the reference package
# chose that width for its own hardware, and the port keeps it so that packed
# leaves convert without reshaping.
_FAST_WIDTH = 64


def f32_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """[..., k] f32 -> [..., 4k] uint8 (bit view, platform byte order)."""
    return x.contiguous().view(torch.uint8)


def bytes_to_f32(b: torch.Tensor) -> torch.Tensor:
    """[..., 4k] uint8 -> [..., k] f32 (inverse bit view). A column slice of
    a wider byte row is not contiguous, so it is copied first."""
    return b.contiguous().view(torch.float32)


def unpack_table(packed: torch.Tensor, emb_dim: int) -> torch.Tensor:
    """[V, W] packed row -> the [V, emb_dim] table columns."""
    return packed[:, :emb_dim]
