"""Dense / MLP tower modules (port of ``pytorchrec_tpu/ops/mlp.py``).

Dense = Linear -> activation -> Dropout, MLP = stack of Dense. ``nn.Linear``
keeps its weight as ``[out, in]``; the flax kernel is ``[in, out]``, so the
converter (``utils/convert.py``) transposes it. Dropout acts only when
``train=True`` (serving never drops) and draws its mask from the
``torch.Generator`` the caller passes (the trainer's), as flax draws from
the ``dropout`` key; kept values scale by ``1 / (1 - rate)``, as in flax.
Every layer built by ``linear`` runs its product at the train step's
matmul precision (``ops/precision.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorchrec_tpu_torch.ops.embedding import INIT_STD
from pytorchrec_tpu_torch.ops.precision import dense_linear
from pytorchrec_tpu_torch.utils.device import resolve_device

_ACTIVATIONS = {
    "relu": torch.relu,
    # flax's nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


def get_activation(name: str) -> Callable:
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; available {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


class Linear(nn.Linear):
    """``nn.Linear`` whose product follows the matmul precision
    (``dense_linear``): full f32 unless a train step runs it under
    ``"bfloat16"``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_linear(x, self.weight, self.bias)


def linear(in_features: int, out_features: int, use_bias: bool = True,
           device=None, generator: Optional[torch.Generator] = None) -> Linear:
    """``Linear`` with the framework's normal(0, 0.01) weight and bias."""
    layer = Linear(in_features, out_features, bias=use_bias, device=resolve_device(device))
    with torch.no_grad():
        layer.weight.normal_(0.0, INIT_STD, generator=generator)
        if use_bias:
            layer.bias.normal_(0.0, INIT_STD, generator=generator)
    return layer


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Zero each value with probability ``rate``, scale the rest by
    ``1 / (1 - rate)``; the mask comes from ``generator`` (None = torch's
    default generator for the device)."""
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator).bool()
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Dense(nn.Module):
    def __init__(self, in_features: int, features: int, activation: str = "relu",
                 dropout: float = 0.0, use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = linear(in_features, features, use_bias, device, generator)
        self.activation = get_activation(activation)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.activation(self.linear(x))
        if self.dropout > 0.0 and train:
            x = dropout(x, self.dropout, generator)
        return x


class MLP(nn.Module):
    def __init__(self, in_features: int, hidden_units_list: Sequence[int],
                 activation: str = "relu", dropout: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        for units in hidden_units_list:
            layers.append(Dense(in_features, units, activation, dropout,
                                device=device, generator=generator))
            in_features = units
        self.layers = nn.ModuleList(layers)
        self.out_features = in_features

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, train=train, generator=generator)
        return x
