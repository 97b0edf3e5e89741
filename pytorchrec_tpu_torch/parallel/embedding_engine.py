"""Sharded embedding lookups (port of
``pytorchrec_tpu/parallel/embedding_engine.py``): ``masked_psum_lookup``.

A table row-sharded over the model axis (``parallel/sharding.py``) is looked
up by every rank of a model group for the same ids: each gathers the rows it
owns, zeroes the others and the partial vectors are summed over the group
(an ``all_reduce``), so every rank ends with the whole vectors. Each id's
row is one term of that sum and the others are zeros, so the sum is exact.

The backward is the identity on the summed vectors. Everything after the
lookup is replicated across the model group, so each rank already holds the
whole gradient of its vectors; its masked gather then keeps the rows it
owns. An all-reduce there (``torch.distributed.nn.functional.all_reduce``'s
backward) would multiply every table gradient by the model group's size.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pytorchrec_tpu_torch.parallel.mesh import Mesh


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum over the model group; backward: the identity."""

    @staticmethod
    def forward(ctx, vectors: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        return mesh.sum_over_model(vectors.clone())

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
