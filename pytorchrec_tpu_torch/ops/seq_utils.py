"""Sequence mask and position helpers (port of
``pytorchrec_tpu/ops/seq_utils.py``).

Position 0 is always marked valid, as in the JAX package: a user with no
history yet attends to the PAD item (id 0), whose row acts as the "no
history" representation.
"""

from __future__ import annotations

import torch


def get_valid_his_index(his_ids: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` item ids -> int32 0/1 validity mask, column 0 forced valid."""
    valid = (his_ids > 0).to(torch.int32)
    valid[:, 0] = 1
    return valid


def get_position_ids(valid_ids: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
    """Reverse position ids ``(len - arange) * valid``: lengths [4, 2, 5] ->
    [[4,3,2,1,0], [2,1,0,0,0], [5,4,3,2,1]]."""
    steps = torch.arange(valid_ids.shape[1], device=valid_ids.device)
    return (seq_len[:, None] - steps) * valid_ids.to(torch.int32)
