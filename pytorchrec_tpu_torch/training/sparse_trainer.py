"""Sparse-embedding trainer (port of
``pytorchrec_tpu/training/sparse_trainer.py``): packed f32 tables with
row-sparse lazy updates.

``SparseEmbeddingTrainer(model, table_optimizer="adam", packed_tables=True)``
keeps each embedding table as one ``[V, W]`` buffer of
``table || moments || staging`` rows (``ops/sparse_update.py``): DCN-v2's
field table, LR's linear table, FM's and DeepFM's both (the linear table's
E is 1, so its rows use 4 of 64 columns under Adam, as in the JAX package).
A train step:

1. gathers the packed rows of the batch's ids once for each table; their
   first E columns go into the model as a leaf tensor that requires grad,
   under the table's own batch key (the model's rows injection,
   ``sharded_table_specs``), so no table takes part in autograd;
2. runs the model, the loss and the backward, which gives the dense
   parameters their gradients and the injected rows theirs;
3. steps the dense optimizer over the dense parameters only;
4. runs ``packed_sparse_update`` (sort, permute, segmented scan, lazy Adam
   or Adagrad, scatter-set) for each table with its pre-update rows, in
   place on its packed buffer, which is never reallocated; Adam's bias
   corrections come from the step's row of scalars (``StepScalars``), so
   the step is the same eagerly and in a CUDA graph (``Trainer.fit_steps``).

The model's table parameter becomes a strided view of the buffer's first E
columns (no grad), so serving and ``unpacked_params`` read the trained table
with no second copy of it.

Unpacked tables, byte rows (``packed_bytes``) and bf16 storage
(``packed_dtype``) come with later work (A8) and raise until then.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import torch
from torch import nn

from pytorchrec_tpu_torch.ops.sparse_update import (
    PACKED_COLS,
    pack_table,
    packed_sparse_update,
    unpack_table,
)
from pytorchrec_tpu_torch.optim import build_optimizer
from pytorchrec_tpu_torch.training.state import SparseTrainState, StepScalars
from pytorchrec_tpu_torch.training.trainer import Batch, Trainer

logger = logging.getLogger(__name__)


def resolve_table_lr(model, override: Optional[float], lr: float, rowwise_tables: bool) -> float:
    """The table optimizer's lr, as every sparse and quantized trainer
    resolves it: an explicit ``table_lr`` override; else, for
    rowwise-Adagrad-style tables (``rowwise_tables``), the model's
    ``table_lr_hint``, or the shared ``lr`` where the model declares
    ``table_lr_shared_ok`` (the CTR family), or the shared ``lr`` with a
    warning (sequence models undertrain their rowwise tables at a dense
    lr); else the shared ``lr``."""
    if override is not None:
        return float(override)
    if rowwise_tables:
        hint = getattr(model, "table_lr_hint", None)
        if hint is not None:
            return float(hint)
        if not getattr(model, "table_lr_shared_ok", False):
            logger.warning(
                "rowwise-Adagrad-style tables on %s fall back to the shared dense lr (%g); "
                "sequence models need an absolute table lr around 1-2e-2: pass table_lr= or "
                "set table_lr_hint on the model", type(model).__name__, lr)
    return lr


def _module_path(path: str):
    """Flax leaf path ``"unified_emb/embedding"`` -> (``"unified_emb"``,
    ``"embedding"``): the port's submodule and its parameter."""
    module, _, name = path.rpartition("/")
    return module.replace("/", "."), name


class SparseEmbeddingTrainer(Trainer):
    """Trainer with packed f32 tables and row-sparse table updates."""

    def __init__(self, model, device=None, table_optimizer: str = "adam",
                 packed_tables: bool = False, packed_bytes: bool = False, packed_dtype=None,
                 table_lr: Optional[float] = None):
        if not hasattr(model, "sharded_table_specs"):
            raise TypeError(f"{type(model).__name__} does not implement sharded_table_specs()")
        if table_optimizer not in PACKED_COLS:
            raise ValueError(f"table_optimizer must be one of {sorted(PACKED_COLS)}, "
                             f"got {table_optimizer!r}")
        if not packed_tables:
            raise NotImplementedError("unpacked tables are not ported yet; pass packed_tables=True")
        if packed_bytes or packed_dtype is not None:
            raise NotImplementedError("byte-packed and bf16 packed tables are not ported yet")
        super().__init__(model, device)
        self.table_optimizer = table_optimizer
        self.packed_tables = packed_tables
        self._table_lr_override = table_lr
        self._table_lr: Optional[float] = None
        self._emb_dims: Dict[str, int] = {}

    def compile(self, *args, lr: float = 1e-3, **kwargs) -> None:
        """As ``Trainer.compile``; the table optimizer's lr comes from
        ``resolve_table_lr``."""
        super().compile(*args, lr=lr, **kwargs)
        self._table_lr = resolve_table_lr(self.model, self._table_lr_override, lr,
                                          rowwise_tables=self.table_optimizer == "rowwise_adagrad")

    def _make_state(self, sample_batch: Batch, rng: torch.Generator) -> SparseTrainState:
        declared = set(self.model.sparse_table_ids(sample_batch))
        paths = {spec["path"] for spec in self.model.sharded_table_specs(sample_batch).values()}
        if declared - paths:
            raise ValueError(f"tables {sorted(declared - paths)} cannot take injected rows")
        packed, table_params = {}, set()
        for path in sorted(paths):
            module_name, param_name = _module_path(path)
            module = self.model.get_submodule(module_name)
            table = getattr(module, param_name).detach()
            self._emb_dims[path] = table.shape[1]
            packed[path] = pack_table(table, self.table_optimizer)
            # the model reads the trained table through a view of the buffer
            setattr(module, param_name, nn.Parameter(unpack_table(packed[path], table.shape[1]),
                                                     requires_grad=False))
            table_params.add(f"{module_name}.{param_name}")
        dense = [p for name, p in self.model.named_parameters() if name not in table_params]
        optimizer = build_optimizer(self.optimizer_name, dense, self.lr, self.weight_decay)
        scalars = StepScalars(adam_tables=sorted(packed) if self.table_optimizer == "adam" else ())
        return SparseTrainState(optimizer=optimizer, rng=rng, scalars=scalars, packed=packed)

    def _step(self, batch: Dict[str, torch.Tensor], scalars: torch.Tensor) -> torch.Tensor:
        """One step: packed gather, forward with injected rows, backward,
        dense optimizer, packed sparse update, whose Adam bias corrections
        come from the step's scalars. Returns the loss (a device scalar)."""
        state = self.state
        injected = dict(batch)
        gathered = []
        for spec in self.model.sharded_table_specs(batch).values():
            path = spec["path"]
            ids = spec["ids"].reshape(-1).to(torch.int32)
            rows = state.packed[path].index_select(0, ids)
            leaf = rows[:, :self._emb_dims[path]].detach().requires_grad_()
            injected[spec["rows_key"]] = leaf
            gathered.append((path, ids, rows, leaf))

        prediction, target = self.model(injected, train=True, generator=state.rng)
        loss = self.loss_fn(prediction, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        adam = self.table_optimizer == "adam"
        for path, ids, rows, leaf in gathered:
            bias_correction = state.scalars.bias_correction(scalars, path) if adam else None
            packed_sparse_update(state.packed[path], rows, ids, leaf.grad, bias_correction,
                                 lr=self._table_lr, optimizer=self.table_optimizer)
        return loss.detach()

    def unpacked_params(self) -> Dict[str, torch.Tensor]:
        """The model's state dict; each table is the ``[V, E]`` view of its
        packed buffer's table columns."""
        self._assert_state()
        return self.model.state_dict()

    def make_serving_fn(self) -> Callable[[Batch], torch.Tensor]:
        """Scorer over the trained state: the model gathers from the table
        columns of the packed buffers."""
        self._assert_state()
        return super().make_serving_fn()
