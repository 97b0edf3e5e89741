"""Sharded embedding lookups and row-gradient exchanges (port of
``pytorchrec_tpu/parallel/embedding_engine.py``).

Tables are split by row over a mesh axis (``parallel/mesh.py``). Two lookup
strategies:

* ``masked_psum_lookup``: every rank of a model group looks up the same
  ids; each gathers the rows it owns, zeroes the others, and the partial
  vectors are summed over the group (an ``all_reduce``). Each id's row is
  one term of that sum and the others are zeros, so the sum is exact. Its
  backward is the identity on the summed vectors: everything after the
  lookup is replicated across the model group, so each rank already holds
  the whole gradient of its vectors, and its masked gather keeps the rows
  it owns (an all-reduce there would multiply every table gradient by the
  group's size).
* ``all_to_all_lookup``: ids are routed to their owner with an
  ``all_to_all``, owners gather, the vectors come back by the reverse
  ``all_to_all``: ``B x E / m`` a hop instead of ``B x E``.

The sharded trainer (``training/sharded_sparse_trainer.py``) keeps its
backward explicit: it injects the looked-up rows as leaves, routes their
per-occurrence gradients to the owners with ``all_to_all_rowgrad`` (or the
grid's ``grid_rowgrad`` and ``two_hop_rowgrad``) and applies row-sparse
updates on the owning shard. So these exchanges take no part in autograd.

Shapes are static, as in the JAX functions: a send matrix ``[m, c]`` of a
fixed capacity ``c`` a destination; padding slots carry a sentinel id past
every shard (``n_shards * rows_per_shard``) with zero grads, which a
table's update drops. The routing is the JAX package's: a stable sort on
the owner and each entry's position within its owner's bucket, so every
owner receives its entries in the JAX order, and the sums it makes of them
(the dedup, the packed update's scan) add in the JAX order.

A bounded ``capacity`` (int: slots; float: a factor over the uniform
expectation, ``bucket_capacity``) stays exact. Where any rank of the axis
overflowed, the lookup runs a second, worst-case round and the rowgrad
exchange appends an ``all_gather`` of the overflowed entries. JAX takes
that round under ``lax.cond`` on a summed flag; here the flag is summed
over the axis (an ``all_reduce``) and read on the host once per exchange,
on the card as on the CPU, so every rank takes the round or none does. The
sharded step runs eagerly (gloo cannot be captured), and gloo stages its
CUDA tensors through the host anyway.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorchrec_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

GRID = (DATA_AXIS, MODEL_AXIS)


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum over the model group; backward: the identity."""

    @staticmethod
    def forward(ctx, vectors: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        return mesh.psum(vectors.clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def owned_ids(ids: torch.Tensor, offset: int, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(local, owned)``: the global ``ids`` as rows of the shard whose
    first row is ``offset``, those of other shards set to ``rows`` (one past
    the shard: the updates drop them), and which ids the shard owns."""
    local = ids - offset
    owned = (local >= 0) & (local < rows)
    return torch.where(owned, local, rows).to(ids.dtype), owned


def masked_psum_lookup(table_shard: torch.Tensor, ids: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """The vectors of the global ``ids [...]`` from this rank's shard
    ``[V/m, E]`` (rows ``[i V/m, (i+1) V/m)`` at model index i) -> ``[..., E]``,
    the same on every rank of the model group; differentiable with respect
    to the shard."""
    rows = table_shard.shape[0]
    local, owned = owned_ids(ids, mesh.model_index * rows, rows)
    vectors = F.embedding(local.clamp(max=rows - 1), table_shard)
    return _SumOverModel.apply(torch.where(owned[..., None], vectors, 0.0), mesh)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


class _Routing(NamedTuple):
    """Owner-bucketed routing plan of a flat id vector: entry ``order[j]``
    goes to slot ``pos_in_bucket[j]`` of bucket ``sorted_owner[j]``;
    ``inverse`` undoes the sort."""

    owner: torch.Tensor          # [b] owner per original entry
    order: torch.Tensor          # [b] stable sort by owner
    inverse: torch.Tensor        # [b] inverse permutation
    sorted_owner: torch.Tensor   # [b]
    pos_in_bucket: torch.Tensor  # [b] position within the owner's bucket


def _route_owners(owner: torch.Tensor, m: int) -> _Routing:
    """Routing plan from a destination vector ``[b]`` (values in
    ``[0, m)``). JAX takes each position from a ``[b, m]`` one-hot cumulative
    sum; in the sorted order that is the distance to the bucket's first
    entry, which ``searchsorted`` finds (the same positions)."""
    b = owner.shape[0]
    sorted_owner, order = torch.sort(owner, stable=True)
    first = torch.searchsorted(sorted_owner, sorted_owner)
    pos = torch.arange(b, device=owner.device) - first
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(b, device=owner.device)
    return _Routing(owner=owner, order=order, inverse=inverse, sorted_owner=sorted_owner,
                    pos_in_bucket=pos)


def _route_by_owner(ids: torch.Tensor, rows_per_shard: int, m: int) -> _Routing:
    return _route_owners(torch.clamp(ids // rows_per_shard, 0, m - 1), m)


def bucket_capacity(n: int, n_shards: int, factor: float = 2.0) -> int:
    """Per-destination bucket capacity for ``n`` ids over ``n_shards``:
    ``factor`` times the uniform expectation ``n / n_shards``, within
    ``[1, n]``. 2.0 puts hashed or uniform streams past the Chernoff tail
    (``P[bucket > 2u] <= 0.68^u``); skewed streams shed their head through
    the hot/cold layout first."""
    return max(1, min(n, int(np.ceil(n / n_shards * factor))))


def _resolve_capacity(capacity, n: int, n_shards: int) -> Optional[int]:
    """``capacity`` as an int: slots; a float: a factor over ``n /
    n_shards`` (``bucket_capacity``); None: the worst case."""
    if capacity is None:
        return None
    if isinstance(capacity, float):
        return bucket_capacity(n, n_shards, capacity)
    return int(capacity)


def _bucketed(values: torch.Tensor, r: _Routing, fits: torch.Tensor, pos: torch.Tensor,
              m: int, c: int, fill) -> torch.Tensor:
    """The ``[m, c, ...]`` send matrix: ``fill`` everywhere, then each
    fitting entry of ``values`` (in the sorted order) at ``(owner, pos)``.
    Entries that do not fit go to one spare slot past the matrix, cut off
    after (JAX's ``mode="drop"``), so no mask reaches the host."""
    at = torch.where(fits, r.sorted_owner * c + pos, m * c)
    flat = values.new_full((m * c + 1, *values.shape[1:]), fill)
    flat[at] = values
    return flat[:m * c].view(m, c, *values.shape[1:])


def _overflowed(mesh: Mesh, axis, count: torch.Tensor) -> bool:
    """Whether any rank of ``axis`` overflowed: the counts summed over the
    axis and read on the host (once per exchange, every rank alike)."""
    total = count.reshape(1).to(torch.int64)
    return bool(mesh.psum(total, axis).item() > 0)


# ---------------------------------------------------------------------------
# 1-D exchanges
# ---------------------------------------------------------------------------


def all_to_all_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                      axis=MODEL_AXIS, capacity=None, out_cols: Optional[int] = None,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows of the global ``ids [b]`` from the table row-sharded over
    ``axis`` (this rank's shard ``table_shard [V/m, W]``): ids routed to
    their owners, gathered there, the rows routed back -> ``[b, W]`` (or
    ``[b, out_cols]``: the owner slices packed rows to their first columns
    before the return hop, so the wire carries E columns, not W).

    ``capacity``: the bucket size a destination (int, float factor, None =
    ``b``); overflowed ids are resolved by a worst-case round taken by the
    whole axis or by none (module docstring). ``valid [b]`` bool: False
    slots go to a virtual bucket (no slot, no bytes, never overflow) and
    return zero rows (``two_hop_lookup`` marks duplicates so)."""
    m = mesh.axis_size(axis)
    rows = table_shard.shape[0]
    b = ids.shape[0]
    capacity = _resolve_capacity(capacity, b, m)
    c = b if capacity is None else min(capacity, b)
    if valid is None:
        r = _route_by_owner(ids, rows, m)
        slot_ok = torch.ones((b,), dtype=torch.bool, device=ids.device)
    else:
        owner = torch.clamp(ids // rows, 0, m - 1)
        r = _route_owners(torch.where(valid, owner, m), m + 1)
        slot_ok = r.sorted_owner < m
    sorted_ids = ids.index_select(0, r.order)
    fits = (r.pos_in_bucket < c) & slot_ok
    pos = torch.where(fits, r.pos_in_bucket, c)
    send = _bucketed(sorted_ids, r, fits, pos, m, c, 0)  # [m, c]
    recv = mesh.all_to_all(send, axis)  # the ids every rank wants from this one
    local = torch.clamp(recv - mesh.axis_index(axis) * rows, 0, rows - 1)
    gathered = table_shard[local]  # [m, c, W]
    if out_cols is not None:
        gathered = gathered[..., :out_cols]
    back = mesh.all_to_all(gathered, axis)  # [m, c, E]
    sorted_rows = back[torch.clamp(r.sorted_owner, max=m - 1), torch.clamp(pos, max=c - 1)]
    if valid is not None:
        sorted_rows = torch.where(slot_ok[:, None], sorted_rows, sorted_rows.new_zeros(()))
    vectors = sorted_rows.index_select(0, r.inverse)
    if capacity is None or c == b:
        return vectors
    need = ((~fits) & slot_ok).index_select(0, r.inverse)
    if not _overflowed(mesh, axis, need.sum()):
        return vectors
    over = all_to_all_lookup(table_shard, ids, mesh, axis, capacity=None, out_cols=out_cols,
                             valid=valid)
    return torch.where(need[:, None], over, vectors)


def _exchange_rowgrads(my_ids: torch.Tensor, my_grads: torch.Tensor, rows_per_shard: int,
                       mesh: Mesh, axis, capacity=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route this rank's ``(ids [k], grads [k, E])`` chunk to the owners
    over ``axis``. Ids at or past the sentinel ``n * rows_per_shard`` go to
    a virtual bucket: they take no slot and never count as overflow.
    Returns ``(ids [n c], grads [n c, E])``, every id owned here or the
    sentinel (with zero grads); with a bounded capacity the overflow
    appendix ``[n k]`` follows (the overflowed entries of every rank,
    gathered, those owned elsewhere set to the sentinel)."""
    n = mesh.axis_size(axis)
    k = my_ids.shape[0]
    capacity = _resolve_capacity(capacity, k, n)
    c = k if capacity is None else min(capacity, k)
    sentinel = n * rows_per_shard
    owner = torch.clamp(my_ids // rows_per_shard, 0, n - 1)
    r = _route_owners(torch.where(my_ids < sentinel, owner, n), n + 1)
    sorted_ids = my_ids.index_select(0, r.order)
    sorted_grads = my_grads.index_select(0, r.order)
    valid = r.sorted_owner < n
    fits = (r.pos_in_bucket < c) & valid
    pos = torch.where(fits, r.pos_in_bucket, c)
    send_ids = _bucketed(sorted_ids, r, fits, pos, n, c, sentinel)
    send_grads = _bucketed(sorted_grads, r, fits, pos, n, c, 0)
    out_ids = mesh.all_to_all(send_ids, axis).reshape(n * c)
    out_grads = mesh.all_to_all(send_grads, axis).reshape(n * c, -1)
    if capacity is None or c == k:
        return out_ids, out_grads
    zero = sorted_grads.new_zeros(())  # dtype-safe: u8 payloads ride here too
    if _overflowed(mesh, axis, ((~fits) & valid).sum()):
        gi = mesh.all_gather(torch.where(fits, sentinel, sorted_ids), axis)
        gg = mesh.all_gather(torch.where(fits[:, None], zero, sorted_grads), axis)
        mine = (torch.clamp(gi // rows_per_shard, 0, n - 1) == mesh.axis_index(axis)) & (
            gi < sentinel)
        app_ids = torch.where(mine, gi, sentinel)
        app_grads = torch.where(mine[:, None], gg, zero)
    else:
        app_ids = my_ids.new_full((n * k,), sentinel)
        app_grads = my_grads.new_zeros((n * k, my_grads.shape[1]))
    return torch.cat([out_ids, app_ids]), torch.cat([out_grads, app_grads])


def _padded_chunk(ids: torch.Tensor, grads: Optional[torch.Tensor], m: int, index: int,
                  fill: int) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """``ids`` (and ``grads``) padded to a multiple of ``m`` with ``fill``
    (and zero rows); this replica's chunk ``index`` of the ``m`` and its
    size k."""
    pad = (-ids.shape[0]) % m
    if pad:
        ids = torch.cat([ids, ids.new_full((pad,), fill)])
        if grads is not None:
            grads = torch.cat([grads, grads.new_zeros((pad, grads.shape[1]))])
    k = ids.shape[0] // m
    chunk = slice(index * k, (index + 1) * k)
    return ids[chunk], None if grads is None else grads[chunk], k


def all_to_all_rowgrad(ids: torch.Tensor, row_grads: torch.Tensor, rows_per_shard: int,
                       mesh: Mesh, axis=MODEL_AXIS, capacity=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route per-occurrence row gradients to their owners over ``axis``.

    ``ids [n]`` / ``row_grads [n, E]`` are the data index's occurrences,
    the same on every rank of the axis; each rank routes only its
    ``1/m`` chunk (n padded to a multiple of m with the sentinel), so each
    occurrence crosses once. Returns ``(ids, grads)`` owned by this rank,
    padding slots carrying the sentinel ``m * rows_per_shard`` and zero
    grads, which the updates drop."""
    m = mesh.axis_size(axis)
    my_ids, my_grads, _ = _padded_chunk(ids, row_grads, m, mesh.axis_index(axis),
                                        m * rows_per_shard)
    return _exchange_rowgrads(my_ids, my_grads, rows_per_shard, mesh, axis, capacity)


# ---------------------------------------------------------------------------
# the (data x model) grid: every row has one owner among all d*m ranks
# ---------------------------------------------------------------------------


def grid_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh, axes=GRID,
                capacity=None, out_cols: Optional[int] = None) -> torch.Tensor:
    """Grid-sharded lookup: ``table_shard [V/(d m), W]`` this rank's rows of
    the grid layout, ``ids [b]`` the data index's ids (the same on the model
    group). Each model replica routes its ``1/m`` chunk over the whole grid
    and the chunks are gathered over the model axis -> ``[b, W or
    out_cols]``, the same on the model group."""
    model_axis = axes[-1]
    b = ids.shape[0]
    my_ids, _, _ = _padded_chunk(ids, None, mesh.axis_size(model_axis),
                                 mesh.axis_index(model_axis), 0)
    vectors = all_to_all_lookup(table_shard, my_ids, mesh, axes, capacity=capacity,
                                out_cols=out_cols)
    return mesh.all_gather(vectors, model_axis)[:b]


def grid_rowgrad(ids: torch.Tensor, row_grads: torch.Tensor, rows_per_shard: int, mesh: Mesh,
                 axes=GRID, capacity=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route the data index's occurrences to their unique grid owner: each
    model replica sends its ``1/m`` chunk over the whole grid. Every
    returned id is owned by this rank or the sentinel ``d m rows``."""
    model_axis = axes[-1]
    my_ids, my_grads, _ = _padded_chunk(ids, row_grads, mesh.axis_size(model_axis),
                                        mesh.axis_index(model_axis),
                                        mesh.axis_size(axes) * rows_per_shard)
    return _exchange_rowgrads(my_ids, my_grads, rows_per_shard, mesh, axes, capacity)


def _segments(keys: torch.Tensor):
    """Stable sort of ``keys`` (``jax.lax.sort`` with an iota payload):
    (sorted keys, order, segment heads)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    one = torch.ones((1,), dtype=torch.bool, device=keys.device)
    return sorted_keys, order, torch.cat([one, sorted_keys[1:] != sorted_keys[:-1]])


def two_hop_rowgrad(ids: torch.Tensor, row_grads: torch.Tensor, rows_per_shard: int,
                    mesh: Mesh, axes=GRID, capacity2=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``grid_rowgrad``'s contract in two hops, matched to a pod whose model
    axis is fast and whose data axis is slow: (1) an ``all_to_all`` over the
    model axis to the rank whose model index is the owner's (``owner %
    m``); (2) duplicate ids summed there (a stable sort and the segmented
    scan, B2: each id's total at its segment's last slot, the rest the
    sentinel); (3) an ``all_to_all`` over the data axis to the owner's
    group, the model index kept, so every entry lands on its owner.

    ``capacity2``: the slow hop's bucket (int; a float is a factor over
    ``k / d``, the real entries a bucket expects, not the ``m k`` slots the
    hop-2 vector holds), exact through the overflow appendix."""
    slow_axis, fast_axis = axes
    m, d = mesh.axis_size(fast_axis), mesh.axis_size(slow_axis)
    sentinel = d * m * rows_per_shard
    my_ids, my_grads, k = _padded_chunk(ids, row_grads, m, mesh.axis_index(fast_axis), sentinel)
    lane = torch.clamp(my_ids // rows_per_shard, 0, d * m - 1) % m
    r = _route_owners(lane, m)
    all_fit = torch.ones_like(r.sorted_owner, dtype=torch.bool)
    send_ids = _bucketed(my_ids.index_select(0, r.order), r, all_fit, r.pos_in_bucket, m, k,
                         sentinel)
    send_grads = _bucketed(my_grads.index_select(0, r.order), r, all_fit, r.pos_in_bucket, m, k,
                           0)
    ids1 = mesh.all_to_all(send_ids, fast_axis).reshape(m * k)
    grads1 = mesh.all_to_all(send_grads, fast_axis).reshape(m * k, -1)

    from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan  # (ops imports us)

    sorted_ids1, order1, is_start = _segments(ids1)
    one = torch.ones((1,), dtype=torch.bool, device=ids1.device)
    is_last = torch.cat([is_start[1:], one])
    total = segmented_sum_scan(grads1.index_select(0, order1).contiguous(), is_start)
    keep = is_last & (sorted_ids1 < sentinel)
    ids2 = torch.where(keep, sorted_ids1, sentinel)
    grads2 = torch.where(keep[:, None], total, 0.0)

    # the owner's group holds rows [g m rps, (g+1) m rps): a 1-D exchange
    # with m * rps rows a shard routes by group
    if isinstance(capacity2, float):
        capacity2 = _resolve_capacity(capacity2, k, d)
    return _exchange_rowgrads(ids2, grads2, rows_per_shard * m, mesh, slow_axis, capacity2)


def two_hop_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh, axes=GRID,
                   capacity2=None, out_cols: Optional[int] = None) -> torch.Tensor:
    """``grid_lookup``'s contract in two hops: each model replica's chunk
    goes over the model axis to the rank whose model index is the owner's;
    duplicate requests there are marked (``valid`` only on a segment's
    first), so each distinct id crosses the data axis once, as a 1-D
    ``all_to_all_lookup`` over the data axis in the lane's own id space
    (``lid = (id // (m rps)) rps + id % rps``); the rows come back,
    duplicates re-expanded from their segment's first, over the model axis,
    and are gathered over it. ``capacity2`` as in ``two_hop_rowgrad``."""
    slow_axis, fast_axis = axes
    m, d = mesh.axis_size(fast_axis), mesh.axis_size(slow_axis)
    rps = table_shard.shape[0]
    b = ids.shape[0]
    my_ids, _, k = _padded_chunk(ids, None, m, mesh.axis_index(fast_axis), 0)
    r = _route_owners((my_ids // rps) % m, m)
    all_fit = torch.ones_like(r.sorted_owner, dtype=torch.bool)
    send = _bucketed(my_ids.index_select(0, r.order), r, all_fit, r.pos_in_bucket, m, k, 0)
    req = mesh.all_to_all(send, fast_axis).reshape(m * k)

    sorted_req, order1, is_start = _segments(req)
    lids = (sorted_req // (m * rps)) * rps + sorted_req % rps
    if isinstance(capacity2, float):
        capacity2 = _resolve_capacity(capacity2, k, d)
    vecs = all_to_all_lookup(table_shard, lids, mesh, slow_axis, capacity=capacity2,
                             out_cols=out_cols, valid=is_start)
    iota = torch.arange(m * k, device=ids.device)
    seg_first = torch.cummax(torch.where(is_start, iota, 0), 0).values
    inverse1 = torch.empty_like(order1)
    inverse1[order1] = iota
    back = vecs[seg_first][inverse1].reshape(m, k, -1)
    back = mesh.all_to_all(back, fast_axis)
    chunk = back[r.sorted_owner, r.pos_in_bucket].index_select(0, r.inverse)
    return mesh.all_gather(chunk, fast_axis)[:b]


def make_sharded_lookup(mesh: Mesh, strategy: str = "psum"):
    """Whole-array lookup over the mesh: ``fn(table [V, E], ids [B])``, both
    the same on every rank, -> ``[B, E]`` on every rank: each rank keeps its
    model shard's rows and its data index's ids, looks them up
    (``masked_psum_lookup``, or ``all_to_all_lookup`` for
    ``strategy="all_to_all"``) and the vectors are gathered over the data
    axis."""
    from pytorchrec_tpu_torch.parallel.mesh import data_sharding

    def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        rows = table.shape[0] // mesh.model
        shard = table[mesh.model_index * rows:(mesh.model_index + 1) * rows]
        local = ids[data_sharding(mesh).rows(ids.shape[0])]
        with torch.no_grad():
            if strategy == "psum":
                vectors = masked_psum_lookup(shard, local, mesh)
            else:
                vectors = all_to_all_lookup(shard, local, mesh, MODEL_AXIS)
        return mesh.all_gather(vectors, DATA_AXIS)

    return lookup
