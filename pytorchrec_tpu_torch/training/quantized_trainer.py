"""Quantized-embedding trainer (port of
``pytorchrec_tpu/training/quantized_trainer.py``): int8/int4 tables,
rowwise Adagrad, stochastic requantization.

``QuantizedEmbeddingTrainer(model, packed_tables=...)`` trains a model's
quantized table in one of two layouts, which the model's ``table_packed``
must match:

* classic (``packed_tables=False``, the JAX package's default): the model's
  buffers ``q`` (int8 ``[V, E]``, or nibble-packed ``[V, E/2]`` at int4) and
  ``scale`` (f32 ``[V]``, or ``[V, G]`` with G column groups), and an f32
  ``[V]`` rowwise-Adagrad accumulator in the state (``table_acc``);
* packed (``packed_tables=True``): one ``[V, W]`` u8 buffer of
  ``q || scale || acc || staging`` rows (``ops/quantized_packed.py``; the
  model's ``unified_q``).

A train step:

1. gathers the batch's rows once (classic: ``q`` and ``scale`` at the ids;
   packed: the byte rows) and dequantizes them into a leaf tensor that
   requires grad, which the model reads in place of its own gather
   (``quantized_table_spec``);
2. runs the model, the loss and the backward;
3. steps the dense optimizer over the model's parameters (the tables are
   buffers, so they take no part: the port's form of ``optax.masked``); a
   model with a linear term keeps its f32 ``unified_lin`` table there, with
   a dense gradient, as the JAX trainer does;
4. updates each table in place, salted from the state's key (the salt
   is a slot of the step's row of scalars, ``StepScalars``, so the step is
   the same eagerly and in a CUDA graph):
   classic, ``classic_quantized_update`` (dedup of the row grads, rowwise
   Adagrad, id-keyed stochastic requantization, B8 at int8 with one scale a
   row, scatter-set of ``q`` and ``scale``, the accumulator's masked add);
   packed, ``packed_quantized_update`` (sort, permute, segmented scan,
   rowwise Adagrad and requantization in B3, scatter-set) with the
   pre-update rows.

Export (``Trainer.export_serving``, ``serving/bundle.py``): the program
bakes the model's own buffers (the packed u8 rows, or the classic ``q`` and
``scale``) and dequantizes in the graph, as the JAX package exports them.

The state's key is the JAX state's (``split(PRNGKey(seed))[1]``), kept on
the host (``utils/rng.py``), so the port draws the JAX package's rounding
bits from the same seed. A checkpoint holds it and the classic
accumulators beside the weights (``_extra_checkpoint``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from pytorchrec_tpu_torch.ops.embedding import normal_init
from pytorchrec_tpu_torch.ops.kernels.quantize import (
    dequantize_rows,
    id_keyed_rounding_bits,
    mean_square_rows,
    quantize_rows,
    stochastic_quantize_rows,
)
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.quantized_packed import (
    dequant_packed_rows,
    pack_quantized_table,
    packed_quantized_update,
    unpack_quantized_table,
)
from pytorchrec_tpu_torch.ops.sparse_update import dedup_row_grads
from pytorchrec_tpu_torch.training.sparse_trainer import resolve_table_lr
from pytorchrec_tpu_torch.training.state import QuantizedTrainState, StepScalars
from pytorchrec_tpu_torch.training.trainer import Batch, Trainer
from pytorchrec_tpu_torch.utils.rng import prng_key, split


def classic_quantized_update(q: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor,
                             ids: torch.Tensor, dvec: torch.Tensor, lr: float,
                             rng_salt: Union[int, torch.Tensor], bits: int = 8,
                             col_groups: int = 1, eps: float = 1e-6) -> None:
    """Rowwise Adagrad and stochastic requantization of a classic table's
    touched rows, in place (the JAX trainer's unpacked step):
    ``q [V, E or E/2]`` int8, ``scale [V]`` or ``[V, G]`` f32, ``acc [V]``
    f32, ``ids [n]`` int32 per-occurrence ids, ``dvec [n, E]`` their grads.

    The duplicates' grads are summed (``dedup_row_grads``), then for each
    unique id ``acc' = acc + mean(g^2)`` and
    ``row = deq(q, scale) - lr * g / (sqrt(acc') + eps)``, requantized with
    the id-keyed bits of ``rng_salt`` (a uint32, or its device word: a slot
    of the trainer's step scalars): at int8 with one scale a row through
    B8's keyed form, which hashes the ids itself; otherwise the bits are
    hashed in torch for ``quantize_rows``. ``q`` and ``scale`` are
    scatter-set with every padding slot routed to ``V`` and dropped, so no
    padding slot overwrites the update of the id it aliases; the
    accumulator takes ``acc += (acc' - acc) * mask``, as JAX stores it."""
    e = dvec.shape[1]
    v = acc.shape[0]
    g = dedup_row_grads(ids, dvec)
    acc_rows = acc.index_select(0, g.ids)
    acc_new = acc_rows + mean_square_rows(g.rows)
    delta = lr * g.rows / (torch.sqrt(acc_new)[:, None] + eps)
    current = dequantize_rows(q.index_select(0, g.ids), scale.index_select(0, g.ids),
                              bits=bits, col_groups=col_groups)
    if bits == 8 and col_groups == 1:
        q_new, s_new = stochastic_quantize_rows(current - delta, ids=g.ids, salt=rng_salt)
    else:
        q_new, s_new = quantize_rows(current - delta,
                                     rng_bits=id_keyed_rounding_bits(g.ids, e, rng_salt),
                                     bits=bits, col_groups=col_groups)
    safe_ids = torch.where(g.mask > 0, g.ids, v).to(torch.int32)
    scatter_set_rows(q, q_new, safe_ids)
    scatter_set_rows(scale.view(v, -1), s_new.reshape(g.ids.shape[0], -1), safe_ids)
    acc.index_add_(0, g.ids, (acc_new - acc_rows) * g.mask)


class QuantizedEmbeddingTrainer(Trainer):
    """Trainer with quantized tables (classic or packed) and row-sparse
    table updates."""

    trains_quantized_tables = True

    def __init__(self, model, device=None, table_eps: float = 1e-6,
                 packed_tables: bool = False, table_lr=None):
        if not hasattr(model, "quantized_table_spec"):
            raise TypeError(f"{type(model).__name__} does not implement quantized_table_spec()")
        super().__init__(model, device)
        self.table_eps = table_eps
        self.packed_tables = packed_tables
        self._table_lr_override = table_lr
        self._table_lr = None
        self._specs: Dict[str, dict] = {}

    def compile(self, *args, lr: float = 1e-3, **kwargs) -> None:
        """As ``Trainer.compile``; quantized rows carry the rowwise-Adagrad
        accumulator, so the table lr resolves as for rowwise tables."""
        super().compile(*args, lr=lr, **kwargs)
        self._table_lr = resolve_table_lr(self.model, self._table_lr_override, lr,
                                          rowwise_tables=True)

    def _buffer(self, path: str) -> torch.Tensor:
        return self.model.get_buffer(path.replace("/", "."))

    def _make_state(self, sample_batch: Batch, rng: torch.Generator) -> QuantizedTrainState:
        """Draw each table from ``rng`` as the JAX package initialises it
        (normal(0, 0.01) rows, round-to-nearest, zero accumulator; a classic
        table's ``q`` and ``scale`` from two independent draws) into the
        model's own buffers, and build the dense optimizer over the model's
        parameters."""
        packed, table_acc = {}, {}
        self._specs = {}
        for name, spec in self.model.quantized_table_spec(sample_batch).items():
            if bool(spec["packed"]) != self.packed_tables:
                raise ValueError(f"model table_packed={spec['packed']} and trainer "
                                 f"packed_tables={self.packed_tables} must agree")
            info = dict(emb=spec["emb_size"], bits=spec["bits"], col_groups=spec["col_groups"],
                        q_path=spec["q"], scale_path=spec["scale"])
            formats = dict(bits=info["bits"], col_groups=info["col_groups"])
            table = self._buffer(spec["q"])
            v = table.shape[0]
            q, scale = quantize_rows(normal_init((v, info["emb"]), self.device, rng), **formats)
            acc = torch.zeros((v,), dtype=torch.float32, device=self.device)
            if self.packed_tables:
                table.copy_(pack_quantized_table(q, scale, acc, info["emb"], info["bits"],
                                                 info["col_groups"]))
                packed[spec["q"]] = table
            else:
                table.copy_(q)
                _, scale = quantize_rows(normal_init((v, info["emb"]), self.device, rng),
                                         **formats)
                self._buffer(spec["scale"]).copy_(scale)
                table_acc[name] = acc
            self._specs[name] = info
        optimizer = self._build_optimizer(self.model.named_parameters())
        key = split(prng_key(rng.initial_seed()))[1]
        scalars = StepScalars(salted_tables=[info["q_path"] for info in self._specs.values()],
                              rng_key=key)
        return QuantizedTrainState(optimizer=optimizer, rng=rng, scalars=scalars, packed=packed,
                                   rng_key=key, table_acc=table_acc)

    def _gather(self, info: dict, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's rows of one table, dequantized: (the packed byte rows,
        or None for a classic table; the f32 rows)."""
        formats = dict(bits=info["bits"], col_groups=info["col_groups"])
        if self.packed_tables:
            rows = self.state.packed[info["q_path"]].index_select(0, ids)
            return rows, dequant_packed_rows(rows, info["emb"], **formats)
        q, scale = self._buffer(info["q_path"]), self._buffer(info["scale_path"])
        return None, dequantize_rows(q.index_select(0, ids), scale.index_select(0, ids),
                                     **formats)

    def _step(self, batch: Dict[str, torch.Tensor], scalars: torch.Tensor) -> torch.Tensor:
        """One step: gather and dequantization, forward with injected rows,
        backward, dense optimizer, quantized table update salted from the
        step's scalars. Returns the loss (a device scalar)."""
        state = self.state
        injected = dict(batch)
        gathered = []
        for name, spec in self.model.quantized_table_spec(batch).items():
            info = self._specs[name]
            ids = spec["ids"].reshape(-1).to(torch.int32)
            rows, values = self._gather(info, ids)
            leaf = values.requires_grad_()
            injected[spec["rows_key"]] = leaf
            gathered.append((name, info, ids, rows, leaf))

        prediction, target = self.model(injected, train=True, generator=state.rng)
        loss = self.loss_fn(prediction, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        for name, info, ids, rows, leaf in gathered:
            salt = state.scalars.salt(scalars, info["q_path"])
            formats = dict(bits=info["bits"], col_groups=info["col_groups"], eps=self.table_eps)
            if self.packed_tables:
                packed_quantized_update(state.packed[info["q_path"]], rows, ids, leaf.grad, None,
                                        self._table_lr, rng_salt=salt, **formats)
            else:
                classic_quantized_update(self._buffer(info["q_path"]),
                                         self._buffer(info["scale_path"]), state.table_acc[name],
                                         ids, leaf.grad, self._table_lr, salt, **formats)
        return loss.detach()

    def _extra_checkpoint(self) -> Dict[str, Any]:
        """A checkpoint's classic accumulators (host copies) and the state's
        key, which salts every step's rounding bits."""
        state = self.state
        return {"table_acc": {name: acc.detach().to("cpu", copy=True)
                              for name, acc in state.table_acc.items()},
                "rng_key": [int(word) for word in state.rng_key]}

    def _load_extra_checkpoint(self, payload: Dict[str, Any]) -> None:
        """The accumulators copied in place; the key into the state and its
        step scalars (``StepScalars.host_rows`` salts from it)."""
        state = self.state
        if set(payload["table_acc"]) != set(state.table_acc):
            raise KeyError(f"accumulators {sorted(payload['table_acc'])}, the state has "
                           f"{sorted(state.table_acc)}")
        with torch.no_grad():
            for name, acc in state.table_acc.items():
                acc.copy_(payload["table_acc"][name])
        key = np.array(payload["rng_key"], dtype=np.uint32)
        state.rng_key = state.scalars.rng_key = key

    def unpacked_quantized(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Host copies of each packed table's (q int8, scale, acc) triple,
        the classic layout (load them into a ``table_packed=False`` model)."""
        state = self._assert_state()
        if not self.packed_tables:
            raise ValueError("unpacked_quantized reads packed tables; a classic table's q and "
                             "scale are the model's buffers and its acc is state.table_acc")
        return {name: unpack_quantized_table(state.packed[info["q_path"]].cpu(), info["emb"],
                                             info["bits"], info["col_groups"])
                for name, info in self._specs.items()}

    def make_serving_fn(self):
        """Scorer over the trained state: the model dequantizes from its own
        buffers, which are the state's tables."""
        self._assert_state()
        return super().make_serving_fn()
