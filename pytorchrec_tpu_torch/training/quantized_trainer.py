"""Quantized-embedding trainer (port of
``pytorchrec_tpu/training/quantized_trainer.py``): int8/int4 packed byte-row
tables, rowwise Adagrad, stochastic requantization.

``QuantizedEmbeddingTrainer(model, packed_tables=True)`` trains a model whose
table is one ``[V, W]`` u8 buffer of ``q || scale || acc || staging`` rows
(``ops/quantized_packed.py``; the model's ``unified_q``). A train step:

1. gathers the packed rows of the batch's ids once and dequantizes them into
   a leaf tensor that requires grad, which the model reads in place of its
   own gather (``quantized_table_spec``);
2. runs the model, the loss and the backward;
3. steps the dense optimizer over the model's parameters (the table is a
   buffer, so it takes no part: the port's form of ``optax.masked``); a
   model with a linear term keeps its f32 ``unified_lin`` table there, with
   a dense gradient, as the JAX trainer does;
4. runs ``packed_quantized_update`` (sort, permute, segmented scan, rowwise
   Adagrad, id-keyed stochastic requantization, scatter-set) with the
   pre-update rows, in place on the buffer, salted from the state's key.

The state's key is the JAX state's (``split(PRNGKey(seed))[1]``), kept on
the host (``utils/rng.py``), so the port draws the JAX package's rounding
bits from the same seed. The classic unpacked ``q``/``scale`` tables come
with later work (A8) and raise until then.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from pytorchrec_tpu_torch.ops.embedding import normal_init
from pytorchrec_tpu_torch.ops.kernels.quantize import quantize_rows, table_rounding_salt
from pytorchrec_tpu_torch.ops.quantized_packed import (
    dequant_packed_rows,
    pack_quantized_table,
    packed_quantized_update,
    unpack_quantized_table,
)
from pytorchrec_tpu_torch.optim import build_optimizer
from pytorchrec_tpu_torch.training.sparse_trainer import resolve_table_lr
from pytorchrec_tpu_torch.training.state import QuantizedTrainState
from pytorchrec_tpu_torch.training.trainer import Batch, Trainer
from pytorchrec_tpu_torch.utils.rng import prng_key, split


class QuantizedEmbeddingTrainer(Trainer):
    """Trainer with packed quantized tables and row-sparse table updates."""

    trains_quantized_tables = True

    def __init__(self, model, device=None, table_eps: float = 1e-6,
                 packed_tables: bool = False, table_lr=None):
        if not hasattr(model, "quantized_table_spec"):
            raise TypeError(f"{type(model).__name__} does not implement quantized_table_spec()")
        if not packed_tables:
            raise NotImplementedError("unpacked q/scale tables are not ported yet; "
                                      "pass packed_tables=True")
        super().__init__(model, device)
        self.table_eps = table_eps
        self.packed_tables = packed_tables
        self._table_lr_override = table_lr
        self._table_lr = None
        self._packed_specs: Dict[str, dict] = {}

    def compile(self, *args, lr: float = 1e-3, **kwargs) -> None:
        """As ``Trainer.compile``; quantized rows carry the rowwise-Adagrad
        accumulator, so the table lr resolves as for rowwise tables."""
        super().compile(*args, lr=lr, **kwargs)
        self._table_lr = resolve_table_lr(self.model, self._table_lr_override, lr,
                                          rowwise_tables=True)

    def _make_state(self, sample_batch: Batch, rng: torch.Generator) -> QuantizedTrainState:
        """Draw each packed table from ``rng`` as the JAX package's
        ``packed_table_init`` does (normal(0, 0.01) rows, round-to-nearest,
        zero accumulator) into the model's own buffer, and build the dense
        optimizer over the model's parameters."""
        packed = {}
        for name, spec in self.model.quantized_table_spec(sample_batch).items():
            if bool(spec["packed"]) != self.packed_tables:
                raise ValueError(f"model table_packed={spec['packed']} and trainer "
                                 f"packed_tables={self.packed_tables} must agree")
            info = dict(emb=spec["emb_size"], bits=spec["bits"], col_groups=spec["col_groups"],
                        q_path=spec["q"])
            table = self.model.get_buffer(spec["q"].replace("/", "."))
            rows = normal_init((table.shape[0], info["emb"]), self.device, rng)
            q, scale = quantize_rows(rows, bits=info["bits"], col_groups=info["col_groups"])
            acc = torch.zeros((table.shape[0],), dtype=torch.float32, device=self.device)
            table.copy_(pack_quantized_table(q, scale, acc, info["emb"], info["bits"],
                                             info["col_groups"]))
            packed[spec["q"]] = table
            self._packed_specs[name] = info
        optimizer = build_optimizer(self.optimizer_name, self.model.parameters(), self.lr,
                                    self.weight_decay)
        seed = rng.initial_seed()
        return QuantizedTrainState(optimizer=optimizer, rng=rng, packed=packed,
                                   rng_key=split(prng_key(seed))[1])

    def train_step(self, batch: Batch) -> torch.Tensor:
        """One step: packed gather and dequantization, forward with injected
        rows, backward, dense optimizer, packed quantized update. Returns the
        loss (a device scalar, not synchronised)."""
        state = self._assert_state()
        batch = self._to_device(batch)
        injected = dict(batch)
        gathered = []
        for name, spec in self.model.quantized_table_spec(batch).items():
            info = self._packed_specs[name]
            ids = spec["ids"].reshape(-1).to(torch.int32)
            rows = state.packed[spec["q"]].index_select(0, ids)
            leaf = dequant_packed_rows(rows, info["emb"], info["bits"],
                                       info["col_groups"]).requires_grad_()
            injected[spec["rows_key"]] = leaf
            gathered.append((spec["q"], info, ids, rows, leaf))

        prediction, target = self.model(injected, train=True, generator=state.rng)
        loss = self.loss_fn(prediction, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        for path, info, ids, rows, leaf in gathered:
            salt = table_rounding_salt(state.rng_key, state.step, path)
            packed_quantized_update(state.packed[path], rows, ids, leaf.grad, None,
                                    self._table_lr, bits=info["bits"],
                                    col_groups=info["col_groups"], eps=self.table_eps,
                                    rng_salt=salt)
        return loss.detach()

    def unpacked_quantized(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Host copies of each packed table's (q int8, scale, acc) triple."""
        state = self._assert_state()
        return {name: unpack_quantized_table(state.packed[info["q_path"]].cpu(), info["emb"],
                                             info["bits"], info["col_groups"])
                for name, info in self._packed_specs.items()}

    def make_serving_fn(self):
        """Scorer over the trained state: the model dequantizes from its own
        buffer, which is the state's packed table."""
        self._assert_state()
        return super().make_serving_fn()
