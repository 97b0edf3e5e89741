"""Feature interactions (port of ``pytorchrec_tpu/ops/interactions.py``): the
FM pairwise interaction and the DCN-v2 cross layers (``dot_interaction``
comes with the DLRM slice).

The JAX package's ``fm_interaction`` reaches its Pallas kernel only with
``use_pallas=True``, which its models never pass: a cost-model choice of the
TPU. The port has no such flag: on the card every call launches the FM
kernels (``ops/kernels/fm.py``), on the CPU the plain version runs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pytorchrec_tpu_torch.ops.embedding import normal_init
from pytorchrec_tpu_torch.ops.kernels import fm
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network


def fm_interaction(field_vectors: torch.Tensor) -> torch.Tensor:
    """FM second-order term, summed over factor dims: ``[..., F, E] ->
    [...]``, ``0.5 * sum_e((sum_f v)^2 - sum_f v^2)``. Lead dims (candidate
    mode ``[B, N, F, E]``) flatten into the kernel's batch."""
    lead = field_vectors.shape[:-2]
    flat = field_vectors.reshape(-1, *field_vectors.shape[-2:]).contiguous()
    return fm.fm_interaction(flat).reshape(lead)


def fm_interaction_vector(field_vectors: torch.Tensor) -> torch.Tensor:
    """Per-factor FM interaction, kept vector-valued: ``[..., F, E] ->
    [..., E]``. Plain torch: the JAX package has no kernel for it."""
    sum_of_fields = field_vectors.sum(dim=-2)
    sum_of_squares = torch.square(field_vectors).sum(dim=-2)
    return 0.5 * (torch.square(sum_of_fields) - sum_of_squares)


def cross_layer_v2(x0: torch.Tensor, xl: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """One DCN-v2 cross layer: ``x0 * (xl @ w + b) + xl``."""
    return x0 * (xl @ w + b) + xl


class CrossNetworkV2(nn.Module):
    """Stack of DCN-v2 cross layers with stacked parameters ``ws [L, D, D]``
    and ``bs [L, D]`` in ``x @ W`` orientation, as the flax leaves
    ``cross/ws`` and ``cross/bs``.

    All layers run in one call of ``cross_network``: the fused kernel on the
    card, its plain version on the CPU. The kernel streams W, so the weights'
    size sets no limit; it takes D <= 512 (``csrc/cross.cu``) and raises
    beyond.
    Candidate-mode input ``[B, N, D]`` is flattened to ``[B*N, D]``.
    ``num_layers=0`` is the identity, with no parameters.
    """

    def __init__(self, num_layers: int, dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.dim = dim
        if num_layers:
            self.ws = nn.Parameter(normal_init((num_layers, dim, dim), device, generator))
            self.bs = nn.Parameter(normal_init((num_layers, dim), device, generator))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        if self.num_layers == 0:
            return x0
        lead = x0.shape[:-1]
        flat = x0.reshape(-1, self.dim).contiguous()
        return cross_network(flat, self.ws, self.bs).reshape(*lead, self.dim)
