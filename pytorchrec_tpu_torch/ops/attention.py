"""Attention ops (port of ``pytorchrec_tpu/ops/attention.py``): DIN
attention pooling.

``DINAttentionPool`` owns its score MLP as explicit parameters ``w0, b0, ...,
w_k, b_k`` in flax's ``[in, out]`` layout and names, so converted weights load
untransposed (``utils/convert.py``). Every call goes through
``ops/kernels/din_attention.py::din_attention_pool``: the CUDA kernel on the
card, at any number of candidates, the plain XLA-equivalent composite on the
CPU. SASRec's ``scaled_dot_product_attention``, ``SASRecBlock`` and
``sasrec_encoder`` come with the sequence-model slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pytorchrec_tpu_torch.ops.embedding import normal_init
from pytorchrec_tpu_torch.ops.kernels.din_attention import ACTIVATIONS, din_attention_pool


class DINAttentionPool(nn.Module):
    """DIN attention pooling of a behaviour sequence against target items:
    the score MLP over ``[hist, target, hist - target, hist * target]``
    (``hidden_units``, then a linear head), invalid steps masked out of the
    softmax, the history rows summed by their weights."""

    def __init__(self, emb_size: int, hidden_units: Sequence[int] = (80, 40),
                 activation: str = "sigmoid", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                             f"got {activation!r}")
        self.hidden_units = tuple(hidden_units)
        self.activation = activation
        dims = [4 * emb_size, *self.hidden_units, 1]
        self.num_layers = len(dims) - 1
        for i in range(self.num_layers):
            setattr(self, f"w{i}", nn.Parameter(normal_init((dims[i], dims[i + 1]), device,
                                                            generator)))
            setattr(self, f"b{i}", nn.Parameter(normal_init((dims[i + 1],), device, generator)))

    def mlp_params(self) -> Tuple[torch.Tensor, ...]:
        """``(w0, b0, ..., w_k, b_k)``, the kernel's order."""
        return tuple(getattr(self, f"{kind}{i}") for i in range(self.num_layers)
                     for kind in ("w", "b"))

    def forward(self, his_vectors: torch.Tensor, target_vector: torch.Tensor,
                valid_his: torch.Tensor) -> torch.Tensor:
        """``his_vectors [B, S, E]``, ``target_vector [B, E]`` or
        ``[B, N, E]``, ``valid_his [B, S]`` (nonzero = valid) -> pooled
        ``[B, E]`` or ``[B, N, E]``."""
        squeeze = target_vector.dim() == 2
        if squeeze:
            target_vector = target_vector[:, None, :]
        pooled = din_attention_pool(his_vectors.contiguous(), target_vector.contiguous(),
                                    valid_his.to(torch.int32).contiguous(), self.mlp_params(),
                                    self.activation)
        return pooled[:, 0, :] if squeeze else pooled
