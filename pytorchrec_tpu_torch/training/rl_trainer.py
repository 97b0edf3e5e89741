"""Value-RL trainers (port of ``pytorchrec_tpu/training/rl_trainer.py``):
twin networks, per-batch "epochs", the target sync inside the step.

``RLTrainer(model)`` trains a ``ValueRLModel`` (``models/rl.py``): the
trainer's ``model`` is its Q-network, every parameter under the dense
optimizer; ``state.target`` is the target network, a copy of it
(``RLTrainState``). A step computes ``(main_q, target_q)`` with
``ValueRLModel.apply`` (the target's Q under ``no_grad``), takes the loss's
gradient, steps the optimizer, and then syncs the target: the step's row of
scalars (``StepScalars(sync_every=update_freq)``) carries the flag
``step % update_freq == 0``, computed on the host from the 1-based step,
and every tensor of the target takes ``torch.where(flag, source, target)``
in place. The copy is predicated on the device, so a step with it is the
same eagerly and in a CUDA graph, and the cadence holds across the edges
of captured calls. The JAX step swaps the trees with ``lax.cond``.

``SparseRLTrainer(model, table_optimizer="adam", table_lr=None,
packed_tables=False, packed_min_width=64)`` trains the tables that the
network's ``sharded_table_specs`` names row-sparsely, as
``SparseEmbeddingTrainer`` does, from the eval network's injected rows:

* unpacked f32 tables (the default): lazy Adam, Adagrad or rowwise Adagrad
  (``sparse_lazy_adam``, ``sparse_adagrad``, ``sparse_rowwise_adagrad``),
  their moments in ``state.table_moments``; the target network gathers
  its own rows in-module;
* the int8 ``i_q`` of a network with ``quantized_table``: rowwise Adagrad
  and id-keyed stochastic requantization (``packed_quantized_update``,
  salted from the step's scalars), the rest unpacked as above; the
  target dequantizes its own rows in-module;
* packed f32 (``packed_tables=True``): each table one ``[V, W]`` buffer
  of ``table || moments || staging`` rows (``packed_sparse_update``);
  one gather of the packed rows feeds the eval network (its first E
  columns, injected) and the update, and the target network's next-step
  rows are gathered from its own table and injected under the network's
  ``sharded_target_specs`` keys. The target keeps a ``[V, E]`` table, the
  columns of the packed rows the network reads; the JAX state copies the
  whole packed leaf, whose other columns nothing reads.

The table lr resolves as JAX's (``resolve_table_lr``, rowwise where the
table optimizer is rowwise Adagrad or the network's table is quantized).
The tables take no part in the dense optimizer (the JAX step zeroes their
dense updates), and ``init_state`` raises if one is ever handed to it.

``fit(reader, batch_size, epochs, ..., dev_freq=100, scan_batches=1)``
counts an "epoch" as one batch, as the reference does: the train stream is
re-shuffled (and pair-wise negatives re-sampled) whenever it runs out, the
callbacks' epoch hooks and ``on_train_batch_end`` run every batch, and the
dev metrics every ``dev_freq`` batches. ``scan_batches=k`` runs windows of
``min(k, dev_freq - epoch % dev_freq, epochs - epoch)`` steps as one call
(on the card one replay of a captured graph a window size), with the epoch
hooks at each window's edges; it needs the packed transfer. Evaluation
ranks the network's Q values through the captured scorer with the
one-hot-first target (the network's ``forward``). A ``mesh`` raises:
multi-device runs are not ported.

Checkpoints hold the target network's leaves beside the trainer's own
(``_extra_checkpoint``), and the sparse trainer's state key.
"""

from __future__ import annotations

from itertools import islice
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from pytorchrec_tpu_torch.data.loader import train_batches
from pytorchrec_tpu_torch.data.schema import TrainMode
from pytorchrec_tpu_torch.models.rl import ValueRLModel
from pytorchrec_tpu_torch.ops.quantized_packed import (
    dequant_packed_rows,
    packed_quantized_update,
    packed_table_init,
)
from pytorchrec_tpu_torch.ops.sparse_update import pack_table, unpack_table
from pytorchrec_tpu_torch.training.callbacks import Callback, CallbackList, History
from pytorchrec_tpu_torch.training.sparse_trainer import SparseEmbeddingTrainer, resolve_table_lr
from pytorchrec_tpu_torch.training.state import RLTrainState, SparseRLTrainState, StepScalars
from pytorchrec_tpu_torch.training.trainer import Batch, Trainer
from pytorchrec_tpu_torch.utils.convert import leaves_of, load_leaves
from pytorchrec_tpu_torch.utils.rng import prng_key, split


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("a mesh (multi-device runs) is not ported yet")


def _words(tensor: torch.Tensor) -> torch.Tensor:
    """A contiguous 1- or 2-byte tensor whose rows hold whole 4-byte words
    (the int8 table's u8 rows) viewed as int32: ``torch.where`` over bytes
    took 1.42 ms for the 403 MB int8 table on the H100, 3.9x its bytes'
    bound."""
    if tensor.element_size() < 4 and tensor.is_contiguous() and tensor.dim() > 0 and \
            tensor.shape[-1] * tensor.element_size() % 4 == 0:
        return tensor.view(torch.int32)
    return tensor


def sync_pairs(model: nn.Module, target: nn.Module) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(source, target) tensors of the target sync: every parameter and
    buffer of the target beside the model's of the same name."""
    source = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return [(_words(source[name].detach()), _words(tensor.detach())) for name, tensor in
            (*target.named_parameters(), *target.named_buffers())]


def _rl_stream(reader, batch_size: int, rng: np.random.Generator, shuffle: bool,
               drop_last: bool, train_mode) -> Iterator[Batch]:
    """The RL fit's train batches, without end: a new shuffled pass (after
    new pair-wise negatives) each time one runs out."""
    while True:
        if train_mode == TrainMode.PAIR_WISE:
            reader.train_neg_sample()
        empty = True
        for batch in train_batches(reader, batch_size, rng, shuffle, drop_last):
            empty = False
            yield batch
        if empty:
            raise ValueError(f"the train split holds no batch of {batch_size} rows")


class _RLTraining:
    """What both RL trainers add to their base: the target network's sync
    and copy in checkpoints, and the per-batch ``fit``."""

    rl_model: ValueRLModel
    _sync: List[Tuple[torch.Tensor, torch.Tensor]]

    def _scalars(self, **kwargs) -> StepScalars:
        return StepScalars(sync_every=self.rl_model.update_freq, **kwargs)

    def _sync_target(self, scalars: torch.Tensor) -> None:
        """Copy the network into the target where the step's flag is set,
        in place, on the device."""
        flag = self.state.scalars.sync_flag(scalars)
        with torch.no_grad():
            for source, target in self._sync:
                torch.where(flag, source, target, out=target)

    def _rl_forward(self, batch: Batch) -> torch.Tensor:
        """The loss of ``(main_q, target_q)`` over ``batch``, the eval
        network drawing its dropout masks from the state's generator."""
        state = self.state
        main_q, target_q = self.rl_model.apply(batch, state.target, train=True,
                                               generator=state.rng)
        return self.loss_fn(main_q, target_q)

    def _target_checkpoint(self) -> Dict[str, Any]:
        return {"target": leaves_of(self.state.target)}

    def fit(self, reader, batch_size: int, epochs: int, train_mode: Optional[TrainMode] = None,
            verbose: int = 1, callbacks: Optional[Union[List[Callback], CallbackList]] = None,
            shuffle: bool = True, drop_last: bool = True, dev_batch_size: Optional[int] = None,
            dev_freq: int = 100, seed: int = 2020, eval_dev: bool = True,
            scan_batches: int = 1) -> History:
        """``epochs`` batches (see the module docstring); ``step_losses``
        holds every step's loss, on the device."""
        self._assert_compiled()
        if scan_batches < 1:
            raise ValueError(f"scan_batches must be at least 1, got {scan_batches}")
        if scan_batches > 1 and not self.packed_transfer:
            raise ValueError("scan_batches > 1 requires packed_transfer")
        if self.state is None:
            bootstrap = reader.get_batch("train",
                                         np.arange(min(2, reader.get_train_dataset_size())))
            self.init_state(bootstrap, seed=seed)
        train_mode = train_mode or reader.train_mode
        if not isinstance(callbacks, CallbackList):
            callbacks = CallbackList(callbacks, add_history=True, add_progbar=verbose != 0,
                                     trainer=self, verbose=verbose, epochs=epochs,
                                     batches=epochs)
        self.history = callbacks.history
        stream = _rl_stream(reader, batch_size, np.random.default_rng(seed), shuffle, drop_last,
                            train_mode)
        losses = torch.zeros((max(epochs, 0),), dtype=torch.float32, device=self.device)
        self.stop_training = False
        callbacks.on_train_begin()
        epoch = 0
        while epoch < epochs and not self.stop_training:
            # the batches up to the next dev evaluation, fed by one prefetch
            # ring, which is closed before the reader is evaluated
            span = min(dev_freq - epoch % dev_freq, epochs - epoch)
            items = self._feed(islice(stream, span))
            try:
                end = epoch + span
                while epoch < end and not self.stop_training:
                    k = min(scan_batches, end - epoch)
                    callbacks.on_epoch_begin(epoch)
                    if self._call(items, k, losses[epoch:]) != k:
                        raise RuntimeError("the train stream ended")
                    epoch += k
                    logs: Dict[str, Any] = {"loss": float(losses[epoch - 1])}
                    if scan_batches == 1:
                        callbacks.on_train_batch_end(epoch - 1, dict(logs))
                    if eval_dev and epoch % dev_freq == 0 and not self.stop_training:
                        logs.update(self.evaluate(reader, split="dev",
                                                  batch_size=dev_batch_size or batch_size,
                                                  verbose=verbose, callbacks=callbacks))
                    callbacks.on_epoch_end(epoch - 1, logs)
            finally:
                if self.packed_transfer:
                    items.close()
        callbacks.on_train_end()
        self.step_losses = losses[:epoch]
        return self.history


class RLTrainer(_RLTraining, Trainer):
    """Trainer for ``ValueRLModel`` (DQN, DEERS, LSRL): dense optimizer over
    the network, the target synced inside the step."""

    def __init__(self, model: ValueRLModel, device=None, packed_transfer: Optional[bool] = None,
                 mesh=None):
        _no_mesh(mesh)
        if not isinstance(model, ValueRLModel):
            raise TypeError(f"RLTrainer trains a ValueRLModel, got {type(model).__name__}")
        if model.qnet.quantized_table:
            raise ValueError("a quantized table trains under SparseRLTrainer")
        self.rl_model = model
        super().__init__(model.qnet, device, packed_transfer)

    def _make_state(self, sample_batch: Batch, rng: torch.Generator) -> RLTrainState:
        target = self.rl_model.make_target()
        self._sync = sync_pairs(self.model, target)
        return RLTrainState(optimizer=self._build_optimizer(self.model.named_parameters()),
                            rng=rng, scalars=self._scalars(), target=target)

    def _step(self, batch: Dict[str, torch.Tensor], scalars: torch.Tensor) -> torch.Tensor:
        """Forward of both networks, backward, the dense optimizer, then the
        target sync of the step's flag. Returns the loss (a device scalar)."""
        state = self.state
        loss = self._rl_forward(batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        self._sync_target(scalars)
        return loss.detach()

    def _extra_checkpoint(self) -> Dict[str, Any]:
        return self._target_checkpoint()

    def _load_extra_checkpoint(self, payload: Dict[str, Any]) -> None:
        load_leaves(payload["target"], self.state.target)


class SparseRLTrainer(_RLTraining, SparseEmbeddingTrainer):
    """RLTrainer with row-sparse table updates: unpacked, int8 or packed f32
    tables (see the module docstring)."""

    trains_quantized_tables = True

    def __init__(self, model: ValueRLModel, device=None, table_optimizer: str = "adam",
                 table_lr: Optional[float] = None, packed_tables: bool = False,
                 packed_min_width: int = 64, mesh=None):
        _no_mesh(mesh)
        if not isinstance(model, ValueRLModel):
            raise TypeError(f"SparseRLTrainer trains a ValueRLModel, got {type(model).__name__}")
        if packed_tables and model.qnet.quantized_table:
            raise ValueError("packed_tables composes with f32 RL tables (a quantized table is "
                             "packed byte rows already)")
        self.rl_model = model
        super().__init__(model.qnet, device, table_optimizer=table_optimizer,
                         rows_injection=True, packed_tables=packed_tables,
                         packed_min_width=packed_min_width, table_lr=table_lr)
        self._q_info: Dict[str, dict] = {}

    def compile(self, *args, lr: float = 1e-3, **kwargs) -> None:
        """As ``Trainer.compile``; the table lr as JAX's SparseRLTrainer
        resolves it, rowwise for rowwise Adagrad or a quantized table."""
        Trainer.compile(self, *args, lr=lr, **kwargs)
        rowwise = self.table_optimizer == "rowwise_adagrad" or self.model.quantized_table
        self._table_lr = resolve_table_lr(self.model, self._table_lr_override, lr, rowwise)

    def _make_state(self, sample_batch: Batch, rng: torch.Generator) -> SparseRLTrainState:
        """The tables that ``sharded_table_specs`` names: an int8 table drawn
        from ``rng`` into the model's buffer (as JAX initialises its
        ``i_q`` leaf), then the target copied, then each f32 table's moments
        or packed buffer (the model's table a view of its first E
        columns); the dense optimizer over the rest."""
        model = self.model
        specs = {spec["path"]: spec for spec in model.sharded_table_specs(sample_batch).values()}
        own = set(model.state_dict())
        self._table_paths = tuple(sorted(p for p in specs if p.replace("/", ".") in own))
        self._q_info = {p: dict(specs[p]["quantized"]) for p in self._table_paths
                        if specs[p].get("quantized")}
        packed, moments = {}, {}
        for path, info in self._q_info.items():
            buffer = model.get_buffer(path.replace("/", "."))
            buffer.copy_(packed_table_init(buffer.shape[0], info["emb_size"], info["bits"],
                                           info["col_groups"], self.device, rng))
            packed[path] = buffer
        target = self.rl_model.make_target()
        tables = set()
        for path in self._table_paths:
            if path in self._q_info:
                continue
            tables.add(path.replace("/", "."))
            table = self._table_param(path).detach()
            e = self._emb_dims[path] = table.shape[1]
            if not self.packed_tables:
                self._table_param(path).requires_grad_(False)
                moments[path] = self._zero_moments(table)
                continue
            moments[path] = {}
            packed[path] = pack_table(table, self.table_optimizer, self.packed_min_width)
            self._set_table_param(path, unpack_table(packed[path], e))
        named = [(name, p) for name, p in model.named_parameters() if name not in tables]
        optimizer = self._build_optimizer(named)
        table_ids = {id(self._table_param(p)) for p in self._table_paths if p not in self._q_info}
        if any(id(p) in table_ids for group in optimizer.param_groups for p in group["params"]):
            raise RuntimeError("a sparse table was handed to the dense optimizer")
        self._sync = sync_pairs(model, target)
        f32_paths = [p for p in self._table_paths if p not in self._q_info]
        key = split(prng_key(rng.initial_seed()))[1]
        scalars = self._scalars(
            adam_tables=f32_paths if self.table_optimizer == "adam" else (),
            salted_tables=list(self._q_info), rng_key=key)
        return SparseRLTrainState(optimizer=optimizer, rng=rng, scalars=scalars, packed=packed,
                                  table_moments=moments, target=target, rng_key=key)

    def _target_rows(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Packed tables: the target network's next-step rows, gathered from
        its own tables, by batch key."""
        target, out = self.state.target, {}
        for spec in self.model.sharded_target_specs(batch).values():
            if spec["path"] in self._table_paths:
                table = target.get_parameter(spec["path"].replace("/", "."))
                out[spec["rows_key"]] = table.index_select(0, spec["ids"].reshape(-1))
        return out

    def _step(self, batch: Dict[str, torch.Tensor], scalars: torch.Tensor) -> torch.Tensor:
        """One step: each table's gather, the forward with the eval rows
        (and, packed, the target's rows) injected, backward, dense
        optimizer, each table's update, then the target sync. Returns the
        loss (a device scalar)."""
        state = self.state
        injected = dict(batch)
        gathered = []
        for spec in self._injection_specs(batch).values():
            path = spec["path"]
            ids = spec["ids"].reshape(-1).to(torch.int32)
            info = self._q_info.get(path)
            if info is not None:
                rows = state.packed[path].index_select(0, ids)
                values = dequant_packed_rows(rows, info["emb_size"], info["bits"],
                                             info["col_groups"])
            else:
                rows, values = self._gather(path, ids)
            leaf = values.detach().requires_grad_()
            injected[spec["rows_key"]] = leaf
            gathered.append((path, ids, rows, leaf))
        if self.packed_tables:
            injected.update(self._target_rows(batch))

        loss = self._rl_forward(injected)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        adam = self.table_optimizer == "adam"
        for path, ids, rows, leaf in gathered:
            info = self._q_info.get(path)
            if info is not None:
                packed_quantized_update(state.packed[path], rows, ids, leaf.grad, None,
                                        self._table_lr, bits=info["bits"],
                                        col_groups=info["col_groups"],
                                        rng_salt=state.scalars.salt(scalars, path))
            else:
                bias_correction = state.scalars.bias_correction(scalars, path) if adam else None
                self._update(path, ids, rows, leaf.grad, bias_correction)
        self._sync_target(scalars)
        return loss.detach()

    def _extra_checkpoint(self) -> Dict[str, Any]:
        return {**super()._extra_checkpoint(), **self._target_checkpoint(),
                "rng_key": [int(word) for word in self.state.rng_key]}

    def _load_extra_checkpoint(self, payload: Dict[str, Any]) -> None:
        super()._load_extra_checkpoint(payload)
        load_leaves(payload["target"], self.state.target)
        key = np.array(payload["rng_key"], dtype=np.uint32)
        self.state.rng_key = self.state.scalars.rng_key = key
