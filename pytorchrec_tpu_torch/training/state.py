"""Train state (port of ``pytorchrec_tpu/training/state.py``).

The JAX package threads one immutable pytree (params, optimizer state, step,
PRNG key) through a jitted step. In the port the parameters live in the
model (an ``nn.Module``) and are updated in place; the state holds what the
model does not: the dense optimizer, the generator of dropout masks, the
step counter, for packed tables the packed
``table || moments || staging`` (f32) or ``q || scale || acc || staging``
(quantized) buffers, and for the classic quantized tables (a ``q`` and a
``scale`` buffer of the model) their rowwise-Adagrad accumulators.

``step`` starts at 0 and counts finished train steps, as JAX's
``state.step``; a step's packed update takes ``step + 1`` (1-based, for
Adam's bias correction).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch


@dataclass
class TrainState:
    optimizer: torch.optim.Optimizer  # over the dense parameters
    rng: torch.Generator  # dropout masks; it drew the initial parameters first
    step: int = 0


@dataclass
class SparseTrainState(TrainState):
    # flax leaf path (``"unified_emb/embedding"``) -> [V, W] packed rows
    packed: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass
class QuantizedTrainState(SparseTrainState):
    # ``packed``: flax leaf path (``"unified_q"``) -> [V, W] u8 packed rows,
    # the model's own buffer, not a copy.
    # The JAX state's PRNG key (``split(PRNGKey(seed))[1]``), numpy uint32[2]:
    # it salts each step's rounding bits (``utils/rng.py``)
    rng_key: Optional[np.ndarray] = None
    # classic tables (``packed_tables=False``): table name (``"unified"``) ->
    # the f32 [V] rowwise-Adagrad accumulator, the JAX state's ``table_acc``
    table_acc: Dict[str, torch.Tensor] = field(default_factory=dict)
