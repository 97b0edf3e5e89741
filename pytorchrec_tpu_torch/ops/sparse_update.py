"""Packed-row layout and the packed row-sparse update (port of
``pytorchrec_tpu/ops/sparse_update.py``).

A packed f32 table keeps everything a row's optimizer needs in one row:

    [0, E)          the embedding row
    [E, E + C')     the optimizer's moments: m || v (adam), acc (adagrad,
                    E columns) or one acc column (rowwise_adagrad)
    [.., W)         zero columns, where the update stages each occurrence's
                    grad (at [C, C + E), C = E + C'), padded to a multiple
                    of 64 columns

so the forward gather of packed rows also fetches the moments, and the
update moves each touched row once (``packed_sparse_update``). The reference
package chose the 64-column multiple for its own hardware; the port keeps it
so that packed leaves convert without reshaping.

``dedup_row_grads`` sums duplicate ids' row grads for the unpacked tables
(the classic quantized rows), with static shapes and no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan

# columns of table || moments, by table optimizer
PACKED_COLS = {"adam": lambda e: 3 * e, "adagrad": lambda e: 2 * e,
               "rowwise_adagrad": lambda e: e + 1}

_FAST_WIDTH = 64
# the packed tables' Adam betas (the JAX update's defaults)
ADAM_B1, ADAM_B2 = 0.9, 0.999


class SparseRowGrad(NamedTuple):
    """Deduplicated row gradients: ``rows[i]`` applies to ``ids[i]``;
    ``mask[i] = 0`` marks padding. ``ids`` are sorted ascending; with
    ``pad_id_base`` padding ids are out of range and strictly unique."""

    ids: torch.Tensor   # [n] int32, sorted ascending
    rows: torch.Tensor  # [n, E]
    mask: torch.Tensor  # [n] 0/1, in the rows' dtype


def dedup_row_grads(ids: torch.Tensor, dvec: torch.Tensor,
                    pad_id_base: Optional[int] = None) -> SparseRowGrad:
    """Combine duplicate ids by summing their row grads, with static shapes:
    ``ids [n]``, ``dvec [n, E]`` -> n slots, the first ``#unique`` holding
    each id's summed grad in ascending id order, the rest masked padding
    with zero rows. Padding ids alias the last unique id (a zero update,
    safe only for a masked add), or, with ``pad_id_base`` (the table's row
    count), are ``pad_id_base + slot``: out of range, ascending and unique.

    One stable sort brings equal ids together in occurrence order, the
    segmented scan (B2) leaves each id's total in its segment's last slot,
    and the k-th slot gathers the k-th segment's last slot (found by
    ``searchsorted`` on the running count of last slots): no atomics, no
    boolean-mask indexing and no host sync."""
    n = ids.shape[0]
    if n == 0:
        return SparseRowGrad(ids.to(torch.int32), dvec, dvec.new_zeros((0,)))
    sorted_ids, order = torch.sort(ids, stable=True)
    moved = dvec.index_select(0, order)
    differs = sorted_ids[1:] != sorted_ids[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=ids.device)
    summed = segmented_sum_scan(moved, torch.cat([one, differs]))
    ends = torch.cumsum(torch.cat([differs, one]), 0)  # last slots up to each slot
    slot = torch.arange(n, device=ids.device)
    valid = slot < ends[-1]
    # slot k takes the (k+1)-th last slot; past #unique, the final slot
    last = torch.searchsorted(ends, slot + 1).clamp_(max=n - 1)
    rows = torch.where(valid[:, None], summed.index_select(0, last), 0.0)
    seg_ids = sorted_ids.index_select(0, last).to(torch.int64)
    if pad_id_base is not None:
        seg_ids = torch.where(valid, seg_ids, pad_id_base + slot)
    return SparseRowGrad(seg_ids.to(torch.int32), rows, valid.to(dvec.dtype))


def f32_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """[..., k] f32 -> [..., 4k] uint8 (bit view, platform byte order)."""
    return x.contiguous().view(torch.uint8)


def bytes_to_f32(b: torch.Tensor) -> torch.Tensor:
    """[..., 4k] uint8 -> [..., k] f32 (inverse bit view). A column slice of
    a wider byte row is copied first: it is not contiguous, or, when it holds
    one row, it is contiguous but may start at a byte offset that is not a
    multiple of 4, where no f32 view exists."""
    b = b.contiguous()
    if b.storage_offset() % 4:
        b = b.clone()
    return b.view(torch.float32)


def packed_width(emb_dim: int, optimizer: str) -> int:
    """Packed row width: table || moments columns plus E staging columns,
    rounded up to a multiple of 64."""
    need = PACKED_COLS[optimizer](emb_dim) + emb_dim
    return -(-need // _FAST_WIDTH) * _FAST_WIDTH


def pack_table(table: torch.Tensor, optimizer: str) -> torch.Tensor:
    """[V, E] f32 table -> [V, W] packed rows: the table columns, then zeros
    (zero-initialised moments and staging)."""
    v, e = table.shape
    packed = table.new_zeros((v, packed_width(e, optimizer)))
    packed[:, :e] = table
    return packed


def unpack_table(packed: torch.Tensor, emb_dim: int) -> torch.Tensor:
    """[V, W] packed row -> the [V, emb_dim] table columns (a strided view)."""
    return packed[:, :emb_dim]


def _bias_correction(beta: float, step: int) -> float:
    """``1 - beta**step`` in f32, as the JAX update computes it from its f32
    step counter."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(step))


def bias_corrections(step: int, b1: float = ADAM_B1, b2: float = ADAM_B2) -> np.ndarray:
    """Adam's bias corrections of the 1-based ``step``, ``[1 - b1**step,
    1 - b2**step]`` as numpy f32 (``_bias_correction``): what the host
    writes into a step's scalars for the packed update to read."""
    return np.array([_bias_correction(b1, step), _bias_correction(b2, step)], dtype=np.float32)


def packed_sparse_update(
    packed: torch.Tensor,   # [V, W] table || moments || staging rows (pack_table)
    rows: torch.Tensor,     # [n, W] the forward gather of packed at ids
    ids: torch.Tensor,      # [n] int32 per-occurrence ids (duplicates allowed)
    dvec: torch.Tensor,     # [n, E] per-occurrence row grads
    bias_correction: Union[torch.Tensor, int, None],  # adam: the step's corrections (below)
    lr: float,
    optimizer: str = "adam",
    b1: float = ADAM_B1,
    b2: float = ADAM_B2,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Row-sparse lazy update of a packed table, in place; returns ``packed``.

    Same passes and arithmetic as the JAX function: stage each occurrence's
    grad in the row's padding columns, permute the staged rows into id order
    with one stable sort (equal ids keep their occurrence order, as under
    ``jax.lax.sort``), sum duplicate ids' grads with the segmented scan
    (each segment's last row holds the total; table and moments are the
    same along a segment, since they came from one row), run the optimizer
    on every row, and scatter-set each segment's last row into the table.
    Other slots route to ``V + slot`` and drop. Untouched rows keep their
    moments (lazy Adam); Adam's bias correction uses the global step:
    ``bias_correction`` is ``[1 - b1**step, 1 - b2**step]``, an f32 ``[2]``
    tensor on the table's device (a slot of the trainer's step scalars,
    ``training/state.py::StepScalars``, which a CUDA graph reads at each
    replay), or the 1-based step as an int, whose corrections
    (``bias_corrections``) are copied to the device here. Other optimizers
    take None.

    The JAX function returns a new table and relies on the caller donating
    the old one; the port writes into ``packed`` itself, so the trainer's
    buffer is never reallocated. ``rows`` must be the pre-update gather of
    this step."""
    if optimizer not in PACKED_COLS:
        raise ValueError(f"unknown table optimizer {optimizer!r}; available {sorted(PACKED_COLS)}")
    n, e = dvec.shape
    w = packed.shape[1]
    c = PACKED_COLS[optimizer](e)
    if w < c + e:
        raise ValueError(f"packed width {w} < {c} table||moment columns + {e} staging columns")
    if n == 0:
        return packed

    sorted_ids, order = torch.sort(ids, stable=True)
    staged = torch.cat([rows[:, :c], dvec.to(rows.dtype), rows.new_zeros((n, w - c - e))], dim=1)
    moved = staged.index_select(0, order)
    differs = sorted_ids[1:] != sorted_ids[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=ids.device)
    is_start = torch.cat([one, differs])
    is_last = torch.cat([differs, one])
    g = segmented_sum_scan(moved[:, c:c + e], is_start)
    t_old = moved[:, :e]

    if optimizer == "adam":
        if not isinstance(bias_correction, torch.Tensor):
            bias_correction = torch.from_numpy(
                bias_corrections(int(bias_correction), b1, b2)).to(packed.device)
        m_old, v_old = moved[:, e:2 * e], moved[:, 2 * e:3 * e]
        new_m = b1 * m_old + (1.0 - b1) * g
        new_v = b2 * v_old + (1.0 - b2) * torch.square(g)
        delta = lr * (new_m / bias_correction[0:1]) / (
            torch.sqrt(new_v / bias_correction[1:2]) + eps)
        pieces = [t_old - delta, new_m, new_v]
    elif optimizer == "adagrad":
        new_acc = moved[:, e:2 * e] + torch.square(g)
        delta = lr * g / (torch.sqrt(new_acc) + 1e-10)
        pieces = [t_old - delta, new_acc]
    else:  # rowwise_adagrad
        new_acc = moved[:, e] + torch.mean(torch.square(g), dim=-1)
        delta = lr * g / (torch.sqrt(new_acc)[:, None] + eps)
        pieces = [t_old - delta, new_acc[:, None]]

    new_packed = torch.cat([*pieces, packed.new_zeros((n, w - c))], dim=1)
    slot = torch.arange(n, dtype=torch.int32, device=ids.device)
    safe_ids = torch.where(is_last, sorted_ids, packed.shape[0] + slot).to(torch.int32)
    return scatter_set_rows(packed, new_packed, safe_ids)
