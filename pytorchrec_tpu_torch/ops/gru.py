"""Masked GRU encoder (port of ``pytorchrec_tpu/ops/gru.py``).

The padded ``[B, S, E]`` sequence runs the full S steps with a validity
mask: a row's hidden state stops changing once ``t >= length``, so the
final state is the state at each row's last valid step, what
``pack_padded_sequence`` and the final hidden state give, with static
shapes, no host sort and no read of the lengths on the host, so a CUDA
graph captures it. ``torch.nn.GRU`` is not used: it computes no masked
scan.

Gates as ``torch.nn.GRU``'s (order r, z, n):

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

The parameters keep the flax layout and names: ``w_ih [in, 3H]``,
``w_hh [H, 3H]``, ``b_ih [3H]`` and ``b_hh [3H]``, all uniform(-1/sqrt(H),
1/sqrt(H)), torch's GRU default and the JAX package's init. The
JAX package scans with ``lax.scan`` outside any Pallas kernel; here one
matmul projects every step's input, then a Python loop of S steps.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pytorchrec_tpu_torch.utils.device import resolve_device


class MaskedGRU(nn.Module):
    def __init__(self, in_features: int, hidden_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.hidden_size = in_features, hidden_size
        device = resolve_device(device)
        h3 = 3 * hidden_size
        for name, shape in (("w_ih", (in_features, h3)), ("w_hh", (hidden_size, h3)),
                            ("b_ih", (h3,)), ("b_hh", (h3,))):
            setattr(self, name, nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                                         device=device)))
        with torch.no_grad():
            self.init_parameters(generator)

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """uniform(-1/sqrt(H), 1/sqrt(H)) from ``generator``, in place."""
        bound = 1.0 / self.hidden_size ** 0.5
        for param in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
            param.uniform_(-bound, bound, generator=generator)

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """``inputs [B, S, E]``, ``lengths [B]`` -> the final hidden state
        ``[B, H]``; a row of length 0 keeps the zero state."""
        batch, seq_len, _ = inputs.shape
        x_proj = torch.matmul(inputs, self.w_ih) + self.b_ih  # [B, S, 3H]
        steps = torch.arange(seq_len, device=inputs.device)
        valid = (steps < lengths[:, None]).unbind(1)  # S x [B]
        h = inputs.new_zeros((batch, self.hidden_size))
        # unbind, not x_proj[:, t]: its backward stacks the S step gradients
        # once, where each slice's would fill and add a whole [B, S, 3H]
        for x_t, valid_t in zip(x_proj.unbind(1), valid):
            xr, xz, xn = x_t.chunk(3, dim=-1)
            hr, hz, hn = (h @ self.w_hh + self.b_hh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1.0 - z) * n + z * h
            h = torch.where(valid_t[:, None], h_new, h)
        return h
