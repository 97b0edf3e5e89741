"""Train state (port of ``pytorchrec_tpu/training/state.py``).

The JAX package threads one immutable pytree (params, optimizer state, step,
PRNG key) through a jitted step. In the port the parameters live in the
model (an ``nn.Module``) and are updated in place; the state holds what the
model does not: the dense optimizer, the generator of dropout masks, the
step counter, for packed tables the packed
``table || moments || staging`` (f32, bf16 or bytes) or
``q || scale || acc || staging`` (quantized) buffers, for unpacked f32
tables their moments, for the classic quantized tables (a ``q`` and a
``scale`` buffer of the model) their rowwise-Adagrad accumulators, and for
the RL trainers the target network (``RLTrainState``,
``SparseRLTrainState``).

``step`` starts at 0 and counts finished train steps, as JAX's
``state.step``; it is the host's count. What a step computes from it (the
1-based step, Adam's bias corrections, the rounding salts, the RL target's
sync flag) a step reads from
its row of ``StepScalars``, which the host fills before each call, so that a
CUDA graph of the step reads each step's values at replay.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pytorchrec_tpu_torch.ops.kernels.quantize import table_rounding_salt
from pytorchrec_tpu_torch.ops.sparse_update import bias_corrections


class StepScalars:
    """The per-step scalars of a train step, laid out as the rows of an
    int32 ``[K, n]`` buffer, a row a step (the JAX step's traced scalars):
    column 0 the 1-based step; for each table that ``adam_tables`` names,
    its two bias corrections ``1 - b1**step`` and ``1 - b2**step`` (f32
    bits); for each table that ``salted_tables`` names, its rounding salt
    (uint32 bits) from the state's key ``rng_key``; with ``sync_every``
    (the RL trainers' ``update_freq``) the target network's sync flag,
    ``step % sync_every == 0``. ``host_rows`` computes each value as the
    eager step always has (``bias_corrections``, numpy f32;
    ``table_rounding_salt``), so the device reads the same bits."""

    def __init__(self, adam_tables: Sequence[str] = (), salted_tables: Sequence[str] = (),
                 rng_key: Optional[np.ndarray] = None, sync_every: int = 0):
        if salted_tables and rng_key is None:
            raise ValueError("salted tables need the state's rng_key")
        self.rng_key = rng_key
        self._bias_col: Dict[str, int] = {}
        self._salt_col: Dict[str, int] = {}
        width = 1
        for path in adam_tables:
            self._bias_col[path], width = width, width + 2
        for path in salted_tables:
            self._salt_col[path], width = width, width + 1
        self.sync_every = sync_every
        self._sync_col = None
        if sync_every > 0:
            self._sync_col, width = width, width + 1
        self.width = width

    def host_rows(self, first_step: int, k: int) -> np.ndarray:
        """The rows of steps ``first_step .. first_step + k - 1`` (1-based):
        ``[k, width]`` int32."""
        rows = np.zeros((k, self.width), dtype=np.int32)
        for i in range(k):
            step = first_step + i
            rows[i, 0] = step
            for path, col in self._bias_col.items():
                rows[i, col:col + 2] = bias_corrections(step).view(np.int32)
            for path, col in self._salt_col.items():
                salt = table_rounding_salt(self.rng_key, step, path)
                rows[i, col] = np.uint32(salt).view(np.int32)
            if self._sync_col is not None:
                rows[i, self._sync_col] = step % self.sync_every == 0
        return rows

    def bias_correction(self, row: torch.Tensor, path: str) -> torch.Tensor:
        """A step's ``[2]`` f32 bias corrections of table ``path``, a view of
        its row."""
        col = self._bias_col[path]
        return row[col:col + 2].view(torch.float32)

    def salt(self, row: torch.Tensor, path: str) -> torch.Tensor:
        """A step's rounding salt of table ``path``: its ``[1]`` int32 word,
        a view of its row."""
        col = self._salt_col[path]
        return row[col:col + 1]

    def sync_flag(self, row: torch.Tensor) -> torch.Tensor:
        """A step's target-sync flag: a 0-d bool tensor on the row's
        device."""
        if self._sync_col is None:
            raise ValueError("these step scalars carry no sync flag (sync_every=0)")
        return row[self._sync_col] != 0


@dataclass
class TrainState:
    optimizer: torch.optim.Optimizer  # over the dense parameters
    rng: torch.Generator  # dropout masks; it drew the initial parameters first
    step: int = 0
    scalars: StepScalars = field(default_factory=StepScalars)


@dataclass
class SparseTrainState(TrainState):
    # flax leaf path (``"unified_emb/embedding"``) -> [V, W] packed rows
    packed: Dict[str, torch.Tensor] = field(default_factory=dict)
    # flax leaf path -> an unpacked table's moments, the JAX state's
    # ``table_moments``: ``{"m", "v"}`` [V, E] (adam), ``{"acc"}`` [V, E]
    # (adagrad) or [V] (rowwise_adagrad); ``{}`` for a packed table, whose
    # moments ride in its rows
    table_moments: Dict[str, Dict[str, torch.Tensor]] = field(default_factory=dict)


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


@dataclass
class RLTrainState(TrainState):
    # the target network: a copy of the model (``ValueRLModel.make_target``)
    # that each step whose sync flag is set copies the model into, in place
    target: Optional[nn.Module] = None


@dataclass
class SparseRLTrainState(SparseTrainState):
    # ``packed``: the packed f32 tables, or the int8 ``i_q`` (the model's
    # own buffer); ``table_moments``: the unpacked tables' moments
    target: Optional[nn.Module] = None
    # the JAX state's PRNG key (``split(PRNGKey(seed))[1]``), numpy
    # uint32[2]: it salts the int8 table's rounding bits
    rng_key: Optional[np.ndarray] = None
