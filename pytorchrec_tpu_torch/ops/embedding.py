"""Embedding table (port of ``pytorchrec_tpu/ops/embedding.py``).

The parameter is named ``embedding`` with shape ``[V, E]``, as the flax leaf
``<name>/embedding``, so converted weights load 1:1. The lookup is a row
gather, ``F.embedding``, not ``index_select``: on the card
``index_select``'s backward sums a row's gradients in no fixed order, and
``F.embedding``'s repeats its bits where each row takes a few of a batch's
ids (a dense user table, say), so a dense table's steps repeat eagerly and
in a CUDA graph alike (``scripts/torch_embedding_determinism.py``). Where a
few rows take thousands of ids each it does not repeat either: SASRec
reads its position table by a one-hot product instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorchrec_tpu_torch.parallel.embedding_engine import masked_psum_lookup
from pytorchrec_tpu_torch.utils.device import resolve_device

# weight-init policy of the whole framework: normal(0, 0.01) for every
# Dense kernel/bias and every Embedding
INIT_STD = 0.01


def normal_init(shape: Sequence[int], device=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """normal(0, 0.01) f32 tensor drawn from ``generator`` (which must live
    on ``device``; None = torch's default generator for that device)."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=resolve_device(device))
    return out.normal_(0.0, INIT_STD, generator=generator)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.embedding = nn.Parameter(
            normal_init((num_embeddings, features), device, generator))
        # the mesh, where ``embedding`` holds this rank's rows of a table
        # row-sharded over its model axis (a trainer's ``mesh=``)
        self.mesh = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            return masked_psum_lookup(self.embedding, ids, self.mesh)
        return F.embedding(ids, self.embedding)
