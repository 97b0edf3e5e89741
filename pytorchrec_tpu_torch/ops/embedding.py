"""Embedding table (port of ``pytorchrec_tpu/ops/embedding.py``).

The parameter is named ``embedding`` with shape ``[V, E]``, as the flax leaf
``<name>/embedding``, so converted weights load 1:1. The lookup is a row
gather (``index_select``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

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

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = torch.index_select(self.embedding, 0, ids.reshape(-1))
        return rows.reshape(*ids.shape, self.features)
