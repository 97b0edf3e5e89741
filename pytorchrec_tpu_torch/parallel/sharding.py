"""Parameter sharding rules (port of ``pytorchrec_tpu/parallel/sharding.py``).

Embedding tables are row-sharded over the mesh's ``model`` axis and every
other parameter is replicated (data-parallel, its gradient averaged over the
data group). The rule is by name over the flat leaves (flax paths, as
``utils/convert.py`` keys them): a table is a 2-D leaf whose path contains
``embedding``, and it is sharded only where the model axis has more than one
rank, its rows are at least ``max(min_rows_to_shard, model)`` and divide by
``model``. Any other table stays replicated, whole on every rank (JAX would
otherwise pad it).

Where JAX's sharding is a placement that XLA lays the rows out by, the
port's is a descriptor, ``RowShard``: the whole table's rows, the rows a
shard holds and this rank's first row; ``shard_params`` keeps this rank's
rows of each sharded leaf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Union

import torch

from pytorchrec_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, Replicated, replicated


@dataclass(frozen=True)
class RowShard:
    """Rows ``[offset, offset + rows_per_shard)`` of a ``rows``-row table:
    this rank's shard, one of those the mesh axis ``axis`` holds (the model
    axis; the sharded trainer's grid layout splits rows over the whole
    ``("data", "model")`` grid)."""

    rows: int
    rows_per_shard: int
    offset: int
    axis: Any = MODEL_AXIS

    def local(self, tensor: torch.Tensor) -> torch.Tensor:
        """This shard's rows of a whole ``[rows, ...]`` tensor (a view)."""
        if tensor.shape[0] != self.rows:
            raise ValueError(f"a shard of a {self.rows}-row table, given {tuple(tensor.shape)}")
        return tensor[self.offset:self.offset + self.rows_per_shard]


Sharding = Union[RowShard, Replicated]


def is_embedding_table(path: str, leaf: torch.Tensor) -> bool:
    """Embedding tables: 2-D leaves whose path contains ``embedding`` (the
    ``Embedding`` module's ``<name>/embedding``, ``ops/embedding.py``)."""
    return leaf.dim() == 2 and "embedding" in path.lower()


def row_shard(rows: int, mesh: Mesh, min_rows_to_shard: int = 0) -> Optional[RowShard]:
    """This rank's shard of a ``rows``-row table under the rule, or None
    where the table stays replicated."""
    m = mesh.model
    if m > 1 and rows >= max(min_rows_to_shard, m) and rows % m == 0:
        return RowShard(rows, rows // m, mesh.model_index * (rows // m))
    return None


def param_shardings(params: Mapping[str, torch.Tensor], mesh: Mesh,
                    min_rows_to_shard: int = 0) -> Dict[str, Sharding]:
    """Each leaf's sharding by flax path: ``RowShard`` for the tables the
    rule shards, ``Replicated`` for the rest."""
    out: Dict[str, Sharding] = {}
    for path, leaf in params.items():
        shard = (row_shard(leaf.shape[0], mesh, min_rows_to_shard)
                 if is_embedding_table(path, leaf) else None)
        out[path] = replicated(mesh) if shard is None else shard
    return out


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh,
                 **kwargs) -> Dict[str, torch.Tensor]:
    """This rank's leaves: its rows of each sharded table (a copy), every
    other leaf as it is."""
    out = {}
    for path, spec in param_shardings(params, mesh, **kwargs).items():
        leaf = params[path]
        out[path] = spec.local(leaf).clone() if isinstance(spec, RowShard) else leaf
    return out
