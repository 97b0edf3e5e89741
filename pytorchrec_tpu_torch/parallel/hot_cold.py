"""Frequency-aware hot/cold embedding placement (port of
``pytorchrec_tpu/parallel/hot_cold.py``).

Real id traffic is Zipfian: a few rows serve most lookups (RecShard, arXiv
2201.10095). Splitting a table by training frequency,

* **hot** rows (the top ``hot_rows`` by count): replicated on every rank of
  the model group and looked up locally, with no exchange;
* **cold** rows (the tail): row-sharded over the model axis and looked up
  through the all-to-all exchange (``parallel/embedding_engine.py``),

cuts the exchange's traffic by the hot share of the lookups. ``build_layout``
is numpy, the JAX package's function (the port keeps its own copy);
``split_table`` and ``merge_table`` (JAX's numpy functions, on tensors of
any dtype) and ``hot_cold_lookup``, the per-rank lookup, are the ones the
sharded trainer runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pytorchrec_tpu_torch.parallel.embedding_engine import all_to_all_lookup
from pytorchrec_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh


class HotColdLayout(NamedTuple):
    """Static layout: ``perm[v]`` maps an original id to its packed id; packed
    ids below ``hot_rows`` live in the hot fragment, the rest (less
    ``hot_rows``) index the cold fragment."""

    perm: np.ndarray       # [V] int32
    inverse: np.ndarray    # [V] int32, packed -> original
    hot_rows: int
    cold_rows: int


def build_layout(counts: np.ndarray, hot_rows: int,
                 pad_cold_to_multiple: int = 1) -> HotColdLayout:
    """Rank rows by count (a stable sort, hottest first); the top
    ``hot_rows`` are hot. ``pad_cold_to_multiple`` rounds the cold fragment
    up so the model axis divides it (padding rows are never referenced)."""
    v = len(counts)
    hot_rows = int(min(hot_rows, v))
    order = np.argsort(-np.asarray(counts), kind="stable")
    perm = np.empty(v, np.int32)
    perm[order] = np.arange(v, dtype=np.int32)
    cold = v - hot_rows
    if pad_cold_to_multiple > 1:
        cold = -(-cold // pad_cold_to_multiple) * pad_cold_to_multiple
    return HotColdLayout(perm=perm, inverse=order.astype(np.int32), hot_rows=hot_rows,
                         cold_rows=cold)


def split_table(table, layout: HotColdLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[V, ...]`` (a tensor of any dtype, or a numpy array) -> (hot
    ``[H, ...]``, cold ``[C, ...]``) in packed order, the cold padding rows
    zeros."""
    table = torch.as_tensor(table)
    packed = table.index_select(0, _index(layout.inverse, table.device))
    cold = table.new_zeros((layout.cold_rows, *table.shape[1:]))
    cold[:len(layout.perm) - layout.hot_rows] = packed[layout.hot_rows:]
    return packed[:layout.hot_rows].clone(), cold


def merge_table(hot, cold, layout: HotColdLayout) -> torch.Tensor:
    """The inverse of ``split_table``: ``[V, ...]`` in the original row
    order, the cold padding dropped."""
    hot, cold = torch.as_tensor(hot), torch.as_tensor(cold)
    packed = torch.cat([hot, cold[:len(layout.perm) - layout.hot_rows]])
    return packed.index_select(0, _index(layout.perm, packed.device))


def _index(order: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(order).to(device=device, dtype=torch.int64)


def hot_cold_lookup(hot: torch.Tensor, cold_shard: torch.Tensor, perm: torch.Tensor,
                    ids: torch.Tensor, mesh: Mesh, axis=MODEL_AXIS, capacity=None,
                    out_cols: Optional[int] = None, with_aux: bool = False):
    """Per-rank lookup: hot ids gather the replicated ``hot [H, X]``, cold
    ids ride the all-to-all to their ``cold_shard [C/m, X]`` (bounded by
    ``capacity``, the first ``out_cols`` columns shipped, as
    ``all_to_all_lookup``). ``perm [V]``; ``ids [B]`` this rank's batch
    rows. Hot ids are routed as cold id 0, their result masked out: the
    exchange keeps its static shape. With ``with_aux``, ``(rows, (packed
    ids, is_hot))``: the second feeds the fragments' backward."""
    hot_rows = hot.shape[0]
    packed = perm[ids]
    is_hot = packed < hot_rows
    hot_vectors = hot[torch.clamp(packed, 0, hot_rows - 1)]
    if out_cols is not None:
        hot_vectors = hot_vectors[:, :out_cols]
    cold_ids = torch.where(is_hot, 0, packed - hot_rows)
    cold_vectors = all_to_all_lookup(cold_shard, cold_ids, mesh, axis, capacity=capacity,
                                     out_cols=out_cols)
    rows = torch.where(is_hot[:, None], hot_vectors, cold_vectors)
    return (rows, (packed, is_hot)) if with_aux else rows


def make_hot_cold_lookup(mesh: Mesh):
    """Whole-array lookup: ``fn(hot [H, E], cold [C, E], perm [V], ids [B])``,
    each the same on every rank, -> ``[B, E]`` on every rank (this rank's
    cold rows and data rows looked up, the vectors gathered over the data
    axis)."""
    from pytorchrec_tpu_torch.parallel.mesh import DATA_AXIS, data_sharding

    def lookup(hot, cold, perm, ids):
        rows = cold.shape[0] // mesh.model
        shard = cold[mesh.model_index * rows:(mesh.model_index + 1) * rows]
        local = ids[data_sharding(mesh).rows(ids.shape[0])]
        with torch.no_grad():
            vectors = hot_cold_lookup(hot, shard, perm, local, mesh)
        return mesh.all_gather(vectors, DATA_AXIS)

    return lookup
