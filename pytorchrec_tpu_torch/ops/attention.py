"""Attention ops (port of ``pytorchrec_tpu/ops/attention.py``): SASRec's
scaled dot-product attention, encoder block and encoder, and DIN attention
pooling.

``scaled_dot_product_attention`` keeps the JAX package's quirk: one global
max over the whole ``[.., Lq, Lk]`` score tensor is subtracted before the
mask (``torch.amax`` over every dimension, whose gradient, as ``jnp.max``'s,
splits evenly among ties), then masked positions become -inf and the
softmax runs over the last axis. ``torch.nn.functional.
scaled_dot_product_attention`` subtracts no global max, so it is not used.
``SASRecBlock`` keeps flax's submodule names, ``Q``, ``K`` (bias-free),
``W1``, ``W2`` and ``LayerNorm_0`` (``scale`` and ``bias``, flax's epsilon
1e-6, not torch's 1e-5), so converted weights load 1:1
(``utils/convert.py``); the keys double as values, and dropout after ``W2``
draws from the caller's generator when ``train`` is true. None of this
reaches a Pallas kernel in the JAX package; it runs as torch operations.

``DINAttentionPool`` owns its score MLP as explicit parameters ``w0, b0, ...,
w_k, b_k`` in flax's ``[in, out]`` layout and names, so converted weights load
untransposed (``utils/convert.py``). Every call goes through
``ops/kernels/din_attention.py::din_attention_pool``: the CUDA kernel on the
card, at any number of candidates, the plain XLA-equivalent composite on the
CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorchrec_tpu_torch.ops.embedding import normal_init
from pytorchrec_tpu_torch.ops.kernels.din_attention import ACTIVATIONS, din_attention_pool
from pytorchrec_tpu_torch.ops.mlp import dropout, linear
from pytorchrec_tpu_torch.utils.device import resolve_device

# flax.linen.LayerNorm's default epsilon
LAYER_NORM_EPS = 1e-6


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: Optional[float] = None,
                                 attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q [.., Lq, D]``, ``k`` and ``v [.., Lk, D]``; ``attn_mask`` nonzero
    = masked out. The global max over every score is subtracted before the
    mask, as in the JAX package."""
    attention = torch.matmul(q, k.transpose(-1, -2))
    if scale is not None:
        attention = attention * scale
    attention = attention - torch.amax(attention)
    if attn_mask is not None:
        attention = attention.masked_fill(attn_mask.bool(), float("-inf"))
    return torch.matmul(torch.softmax(attention, dim=-1), v)


class LayerNorm(nn.Module):
    """flax's ``LayerNorm`` over the last axis: ``scale`` (ones) and
    ``bias`` (zeros) as explicit parameters, epsilon 1e-6."""

    def __init__(self, features: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.features = features
        self.scale = nn.Parameter(torch.ones((features,), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros((features,), dtype=torch.float32, device=device))

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Ones and zeros, as flax initialises them (``generator`` unused)."""
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (self.features,), self.scale, self.bias, eps=LAYER_NORM_EPS)


class SASRecBlock(nn.Module):
    """One SASRec layer: self-attention, then ``W1``, relu, ``W2``, dropout,
    the residual and ``LayerNorm_0``."""

    def __init__(self, emb_size: int, dropout: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.emb_size, self.dropout = emb_size, dropout
        self.Q = linear(emb_size, emb_size, use_bias=False, device=device, generator=generator)
        self.K = linear(emb_size, emb_size, use_bias=False, device=device, generator=generator)
        self.W1 = linear(emb_size, emb_size, device=device, generator=generator)
        self.W2 = linear(emb_size, emb_size, device=device, generator=generator)
        self.LayerNorm_0 = LayerNorm(emb_size, device)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        key = self.K(x)
        context = scaled_dot_product_attention(self.Q(x), key, key, scale=self.emb_size ** -0.5,
                                               attn_mask=attn_mask)
        out = self.W2(torch.relu(self.W1(context)))
        if train and self.dropout > 0.0:
            out = dropout(out, self.dropout, generator)
        return self.LayerNorm_0(x + out)


def sasrec_encoder(his_vectors: torch.Tensor, valid_his: torch.Tensor, his_len: torch.Tensor,
                   blocks: Sequence[SASRecBlock], train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The blocks over ``his_vectors [B, L, E]`` (key positions where
    ``valid_his [B, L]`` is 0 masked out), then the mean over the valid
    positions: their sum over ``his_len [B]``."""
    batch, length, _ = his_vectors.shape
    attn_mask = 1 - valid_his[:, None, :].expand(batch, length, length)
    x = his_vectors
    for block in blocks:
        x = block(x, attn_mask, train=train, generator=generator)
    pooled = torch.sum(x * valid_his[..., None].to(x.dtype), dim=1)
    return pooled / his_len[:, None].to(x.dtype)


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
