"""Row-sparse table updates and the packed-row layouts (port of
``pytorchrec_tpu/ops/sparse_update.py``).

Unpacked tables (``SparseEmbeddingTrainer``'s default) keep the table
``[V, E]`` and its moments apart: ``sparse_lazy_adam`` (``m``, ``v``
``[V, E]``), ``sparse_adagrad`` (``acc [V, E]``) and
``sparse_rowwise_adagrad`` (``acc [V]``). Each sums duplicate ids' grads
(``dedup_row_grads``), runs the optimizer on the unique rows and scatter-sets
each array's new rows (B4), padding slots routed out of range.

A packed f32 table keeps everything a row's optimizer needs in one row:

    [0, E)          the embedding row
    [E, E + C')     the optimizer's moments: m || v (adam), acc (adagrad,
                    E columns) or one acc column (rowwise_adagrad)
    [.., W)         zero columns, where the update stages each occurrence's
                    grad (at [C, C + E), C = E + C'), padded to a multiple
                    of 64 columns, at least ``min_width``

so the forward gather of packed rows also fetches the moments, and the
update moves each touched row once (``packed_sparse_update``). The rows may
be stored in bf16 (``pack_table(dtype=torch.bfloat16)``), the optimizer's
arithmetic staying f32; or as bytes (``pack_table_bytes``: the same f32
fields bit for bit in a u8 row, 64-byte multiples), whose update
(``packed_sparse_update_bytes``) is bit-identical to the f32 one. The
reference package chose the 64-column multiple for its own hardware; the
port keeps it so that packed leaves convert without reshaping.
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


def mean_square_rows(g: torch.Tensor) -> torch.Tensor:
    """``[n, e] -> [n]``: ``mean(g**2)`` along each row, summed from column 0
    up and divided by ``e`` (a division, correctly rounded on every device,
    not a product with ``1/e``): the rowwise-Adagrad increment, as the JAX
    package's CPU reduction and the requantize kernel compute it."""
    squares = torch.square(g).t().contiguous()  # each column's squares contiguous
    total = squares[0]
    for c in range(1, g.shape[1]):
        total = total + squares[c]
    return total / torch.full_like(total, g.shape[1])


def _check_min_width(min_width: int) -> None:
    if min_width % _FAST_WIDTH:
        raise ValueError(f"min_width must be a multiple of {_FAST_WIDTH}, got {min_width}")


def packed_width(emb_dim: int, optimizer: str, min_width: int = _FAST_WIDTH) -> int:
    """Packed row width in columns of the row's dtype: table || moments
    columns plus E staging columns, rounded up to a multiple of 64, and at
    least ``min_width`` (a multiple of 64)."""
    _check_min_width(min_width)
    need = PACKED_COLS[optimizer](emb_dim) + emb_dim
    return max(min_width, -(-need // _FAST_WIDTH) * _FAST_WIDTH)


def pack_table(table: torch.Tensor, optimizer: str, min_width: int = _FAST_WIDTH,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[V, E] table -> [V, W] packed rows: the table columns, then zeros
    (zero-initialised moments and staging), stored in ``dtype`` (the
    table's own by default; bf16 rounds to nearest even)."""
    v, e = table.shape
    packed = table.new_zeros((v, packed_width(e, optimizer, min_width)),
                             dtype=table.dtype if dtype is None else dtype)
    packed[:, :e] = table
    return packed


def unpack_table(packed: torch.Tensor, emb_dim: int) -> torch.Tensor:
    """[V, W] packed row -> the [V, emb_dim] table columns (a strided view)."""
    return packed[:, :emb_dim]


def packed_bytes_width(emb_dim: int, optimizer: str, min_width: int = _FAST_WIDTH) -> int:
    """Byte-row width: 4 bytes a table || moments field plus 4E staging
    bytes, rounded up to a multiple of 64 bytes, and at least ``min_width``
    bytes (rowwise Adagrad at E=16: 132 bytes of fields, a 192-byte row)."""
    _check_min_width(min_width)
    need = 4 * PACKED_COLS[optimizer](emb_dim) + 4 * emb_dim
    return max(min_width, -(-need // _FAST_WIDTH) * _FAST_WIDTH)


def pack_table_bytes(table: torch.Tensor, optimizer: str,
                     min_width: int = _FAST_WIDTH) -> torch.Tensor:
    """[V, E] f32 table -> [V, W] u8 rows: the table's bits, zero moments and
    staging."""
    v, e = table.shape
    packed = torch.zeros((v, packed_bytes_width(e, optimizer, min_width)), dtype=torch.uint8,
                         device=table.device)
    packed.view(torch.float32)[:, :e] = table
    return packed


def unpack_table_bytes(packed: torch.Tensor, emb_dim: int) -> torch.Tensor:
    """[V, W] u8 packed rows -> the [V, emb_dim] f32 table columns (a strided
    f32 view of the rows)."""
    return packed.view(torch.float32)[:, :emb_dim]


def _bias_correction(beta: float, step: int) -> float:
    """``1 - beta**step`` in f32, as the JAX update computes it from its f32
    step counter."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(step))


def bias_corrections(step: int, b1: float = ADAM_B1, b2: float = ADAM_B2) -> np.ndarray:
    """Adam's bias corrections of the 1-based ``step``, ``[1 - b1**step,
    1 - b2**step]`` as numpy f32 (``_bias_correction``): what the host
    writes into a step's scalars for the packed update to read."""
    return np.array([_bias_correction(b1, step), _bias_correction(b2, step)], dtype=np.float32)


def _step_corrections(bias_correction: Union[torch.Tensor, int], device, b1: float,
                      b2: float) -> torch.Tensor:
    """Adam's ``[1 - b1**step, 1 - b2**step]`` on ``device``: the tensor as
    given, or computed from the 1-based step."""
    if isinstance(bias_correction, torch.Tensor):
        return bias_correction
    return torch.from_numpy(bias_corrections(int(bias_correction), b1, b2)).to(device)


def _optimizer_rows(optimizer: str, fields: torch.Tensor, g: torch.Tensor,
                    bias_correction, lr: float, b1: float, b2: float, eps: float) -> list:
    """The row-sparse optimizers' arithmetic, in f32: ``fields [n, C]`` the
    rows' ``table || moments`` columns, ``g [n, E]`` the summed grads;
    returns the new columns, piece by piece (table, then each moment), as the
    JAX updates compute them. ``eps`` is the optimizer's (the packed updates
    give Adagrad 1e-10, as JAX's do)."""
    e = g.shape[1]
    t_old = fields[:, :e]
    if optimizer == "adam":
        bias_correction = _step_corrections(bias_correction, g.device, b1, b2)
        m_old, v_old = fields[:, e:2 * e], fields[:, 2 * e:3 * e]
        new_m = b1 * m_old + (1.0 - b1) * g
        new_v = b2 * v_old + (1.0 - b2) * torch.square(g)
        delta = lr * (new_m / bias_correction[0:1]) / (
            torch.sqrt(new_v / bias_correction[1:2]) + eps)
        return [t_old - delta, new_m, new_v]
    if optimizer == "adagrad":
        new_acc = fields[:, e:2 * e] + torch.square(g)
        delta = lr * g / (torch.sqrt(new_acc) + eps)
        return [t_old - delta, new_acc]
    new_acc = fields[:, e] + mean_square_rows(g)  # rowwise_adagrad
    delta = lr * g / (torch.sqrt(new_acc)[:, None] + eps)
    return [t_old - delta, new_acc[:, None]]


def _field_columns(optimizer: str, e: int) -> int:
    """Columns of ``table || moments`` under ``optimizer`` (raises on an
    unknown one)."""
    if optimizer not in PACKED_COLS:
        raise ValueError(f"unknown table optimizer {optimizer!r}; available {sorted(PACKED_COLS)}")
    return PACKED_COLS[optimizer](e)


def _packed_eps(optimizer: str, eps: float) -> float:
    """The packed updates' eps: ``eps`` for Adam and rowwise Adagrad, 1e-10
    for Adagrad (the JAX functions' constant)."""
    return 1e-10 if optimizer == "adagrad" else eps


def _sorted_segments(ids: torch.Tensor):
    """Stable sort of ``ids`` (equal ids keep their occurrence order, as
    under ``jax.lax.sort``): (sorted ids, order, segment heads, segment
    ends)."""
    sorted_ids, order = torch.sort(ids, stable=True)
    differs = sorted_ids[1:] != sorted_ids[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=ids.device)
    return sorted_ids, order, torch.cat([one, differs]), torch.cat([differs, one])


def _scatter_last(packed: torch.Tensor, new_rows: torch.Tensor, sorted_ids: torch.Tensor,
                  is_last: torch.Tensor) -> torch.Tensor:
    """Scatter-set each segment's last row; the other slots route to
    ``V + slot`` and drop."""
    slot = torch.arange(new_rows.shape[0], dtype=torch.int32, device=sorted_ids.device)
    safe_ids = torch.where(is_last, sorted_ids, packed.shape[0] + slot).to(torch.int32)
    return scatter_set_rows(packed, new_rows, safe_ids)


def packed_sparse_update(
    packed: torch.Tensor,   # [V, W] table || moments || staging rows (pack_table), f32 or bf16
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

    bf16 rows: the grads are staged in bf16 (rounded, as in the JAX
    function), every field is converted to f32 before the arithmetic (the
    scan reads a contiguous f32 copy of the staged grads) and the new row is
    rounded to bf16 only when written.

    The JAX function returns a new table and relies on the caller donating
    the old one; the port writes into ``packed`` itself, so the trainer's
    buffer is never reallocated. ``rows`` must be the pre-update gather of
    this step."""
    n, e = dvec.shape
    w = packed.shape[1]
    c = _field_columns(optimizer, e)
    if w < c + e:
        raise ValueError(f"packed width {w} < {c} table||moment columns + {e} staging columns")
    if n == 0:
        return packed
    sorted_ids, order, is_start, is_last = _sorted_segments(ids)
    staged = torch.cat([rows[:, :c], dvec.to(rows.dtype), rows.new_zeros((n, w - c - e))], dim=1)
    moved = staged.index_select(0, order)
    g = segmented_sum_scan(moved[:, c:c + e].to(torch.float32), is_start)
    pieces = _optimizer_rows(optimizer, moved[:, :c].to(torch.float32), g, bias_correction, lr,
                             b1, b2, _packed_eps(optimizer, eps))
    new_packed = torch.cat([*pieces, g.new_zeros((n, w - c))], dim=1).to(packed.dtype)
    return _scatter_last(packed, new_packed, sorted_ids, is_last)


def packed_sparse_update_bytes(
    packed: torch.Tensor,   # [V, W] u8 rows (pack_table_bytes)
    rows: torch.Tensor,     # [n, W] the forward gather of packed at ids
    ids: torch.Tensor,      # [n] int32 per-occurrence ids (duplicates allowed)
    dvec: torch.Tensor,     # [n, E] per-occurrence f32 row grads
    bias_correction: Union[torch.Tensor, int, None],
    lr: float,
    optimizer: str = "adam",
    b1: float = ADAM_B1,
    b2: float = ADAM_B2,
    eps: float = 1e-8,
) -> torch.Tensor:
    """``packed_sparse_update`` over byte rows, in place; returns ``packed``.
    A byte row's f32 view is a packed f32 row of ``W / 4`` columns (the same
    fields at the same offsets, the grads staged at byte ``4C``), so the f32
    update runs on the views: the same passes (B2 reads the staged grads at
    the rows' stride, B4 writes the rows' bytes) and the same arithmetic, so
    the result is bit-identical to the f32 layout's, as the JAX function's
    bitcasts make it."""
    if packed.dtype != torch.uint8 or packed.shape[1] % 4:
        raise ValueError(f"byte rows are u8 of a multiple of 4 bytes; got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    packed_sparse_update(packed.view(torch.float32), rows.view(torch.float32), ids, dvec,
                         bias_correction, lr, optimizer, b1, b2, eps)
    return packed


def _unpacked_update(optimizer: str, table: torch.Tensor, moments: list, ids: torch.Tensor,
                     dvec: torch.Tensor, bias_correction, lr: float, b1: float, b2: float,
                     eps: float) -> None:
    """An unpacked table's row-sparse update, in place: the duplicates'
    grads summed (``dedup_row_grads`` with ``pad_id_base = V``), the unique
    rows of the table and of each moment gathered (padding ids clipped to
    the last row, as JAX's ``mode="clip"``), the packed updates' arithmetic
    (``_optimizer_rows``), and each array's new rows scatter-set by B4
    (padding drops; a ``[V]`` accumulator as ``[V, 1]`` rows of 4 bytes).
    JAX adds ``-delta`` to the table and ``new - old`` to each moment; the
    port sets the sums that would make, ``t + (-delta)`` (``t - delta`` bit
    for bit) and ``old + (new - old)`` (which need not be ``new``), so the
    stored bits are JAX's."""
    g = dedup_row_grads(ids, dvec, pad_id_base=table.shape[0])
    n = g.ids.shape[0]
    safe = g.ids.clamp(max=table.shape[0] - 1)
    olds = [a.index_select(0, safe).view(n, -1) for a in (table, *moments)]
    new = _optimizer_rows(optimizer, torch.cat(olds, dim=1), g.rows, bias_correction, lr, b1, b2,
                          eps)
    scatter_set_rows(table, new[0], g.ids)
    for array, old, value in zip(moments, olds[1:], new[1:]):
        scatter_set_rows(array.view(array.shape[0], -1), old + (value - old), g.ids)


def sparse_lazy_adam(
    table: torch.Tensor,   # [V, E]
    m: torch.Tensor,       # [V, E]
    v: torch.Tensor,       # [V, E]
    ids: torch.Tensor,     # [n] int32 per-occurrence ids (duplicates allowed)
    dvec: torch.Tensor,    # [n, E] per-occurrence row grads
    bias_correction: Union[torch.Tensor, int],
    lr: float,
    b1: float = ADAM_B1,
    b2: float = ADAM_B2,
    eps: float = 1e-8,
):
    """Row-sparse (lazy) Adam of an unpacked table, in place
    (``_unpacked_update``); returns ``(table, m, v)``. Only the batch's rows
    change; untouched rows keep their moments. ``bias_correction`` as in
    ``packed_sparse_update``."""
    _unpacked_update("adam", table, [m, v], ids, dvec, bias_correction, lr, b1, b2, eps)
    return table, m, v


def sparse_adagrad(table: torch.Tensor, accum: torch.Tensor, ids: torch.Tensor,
                   dvec: torch.Tensor, lr: float, eps: float = 1e-10):
    """Row-sparse Adagrad of an unpacked table (``accum [V, E]``), in place;
    returns ``(table, accum)``."""
    _unpacked_update("adagrad", table, [accum], ids, dvec, None, lr, ADAM_B1, ADAM_B2, eps)
    return table, accum


def sparse_rowwise_adagrad(table: torch.Tensor, accum: torch.Tensor, ids: torch.Tensor,
                           dvec: torch.Tensor, lr: float, eps: float = 1e-8):
    """Row-wise Adagrad of an unpacked table, one accumulator a row
    (``accum [V]``), in place; returns ``(table, accum)``:
    ``acc += mean(g**2)`` (``mean_square_rows``),
    ``row -= lr * g / (sqrt(acc) + eps)``."""
    _unpacked_update("rowwise_adagrad", table, [accum], ids, dvec, None, lr, ADAM_B1, ADAM_B2,
                     eps)
    return table, accum
