"""Sparse-embedding trainer (port of
``pytorchrec_tpu/training/sparse_trainer.py``): row-sparse lazy updates of
embedding tables.

``SparseEmbeddingTrainer(model, table_optimizer="adam", rows_injection=None,
packed_tables=False, packed_min_width=64, packed_bytes=False,
packed_dtype=None, table_lr=None)`` keeps the dense parameters on the dense
optimizer and updates each embedding table with row-sparse lazy Adam,
Adagrad or rowwise Adagrad (``ops/sparse_update.py``). A table is stored in
one of four formats:

* unpacked (the default): the model's own ``[V, E]`` table, its moments in
  ``state.table_moments`` (``sparse_lazy_adam``, ``sparse_adagrad``,
  ``sparse_rowwise_adagrad``);
* packed f32 (``packed_tables=True``): one ``[V, W]`` buffer of
  ``table || moments || staging`` rows, ``W`` at least ``packed_min_width``
  columns (``packed_sparse_update``); the model's table parameter becomes a
  strided view of the buffer's first E columns, so serving and
  ``unpacked_params`` read the trained table with no second copy. DeepFM's
  linear table (E=1) uses 4 of its 64 columns under Adam, as in the JAX
  package;
* packed bf16 (``packed_dtype="bfloat16"``): the same rows stored in bf16,
  the optimizer's arithmetic in f32;
* byte rows (``packed_bytes=True``, which implies ``packed_tables``): the
  f32 fields' bits in u8 rows (``packed_sparse_update_bytes``, bit-identical
  to packed f32; ``packed_min_width`` then counts bytes).

With bf16 or byte rows the model keeps no table of its own (an empty
``[0, E]`` parameter, so that nothing reads a stale copy): scoring gathers
the packed rows and injects their f32 values, and ``unpacked_params``
unpacks them.

A train step:

1. gathers each table's rows at the batch's ids once; their f32 values go
   into the model as a leaf tensor that requires grad, under the table's own
   batch key, so no table takes part in autograd and no dense ``[V, E]``
   gradient is ever made;
2. runs the model, the loss and the backward, which gives the dense
   parameters their gradients and the injected rows theirs;
3. steps the dense optimizer over the dense parameters only;
4. updates each table in place (its buffers are never reallocated) from its
   per-occurrence row grads; Adam's bias corrections come from the step's
   row of scalars (``StepScalars``), so the step is the same eagerly and in
   a CUDA graph (``Trainer.fit_steps``).

Rows injection: with ``rows_injection=True`` the tables are the ones the
model's ``sharded_table_specs`` names (unified tables); ``None`` resolves at
``init_state`` as the JAX trainer resolves it, to True where every table the
model declares (``sparse_table_ids``) is named there and to False otherwise
(per-field tables). Where the JAX step then patches the rows into a
stop-gradient copy of each table, the port injects them all the same,
through the model's ``injection_specs``, which also names per-field tables:
each id's summed gradient is the same, summed in another order. Packed
tables need rows injection, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from pytorchrec_tpu_torch.ops.sparse_update import (
    PACKED_COLS,
    pack_table,
    pack_table_bytes,
    packed_sparse_update,
    packed_sparse_update_bytes,
    sparse_adagrad,
    sparse_lazy_adam,
    sparse_rowwise_adagrad,
    unpack_table,
    unpack_table_bytes,
)
from pytorchrec_tpu_torch.training.state import SparseTrainState, StepScalars
from pytorchrec_tpu_torch.training.trainer import Batch, Trainer

logger = logging.getLogger(__name__)

# packed_dtype -> the rows' storage dtype (None: f32)
_STORAGE = {"float32": None, torch.float32: None, "bfloat16": torch.bfloat16,
            torch.bfloat16: torch.bfloat16}


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
    """Trainer with row-sparse table updates over unpacked, packed f32,
    packed bf16 or byte-row tables."""

    def __init__(self, model, device=None, table_optimizer: str = "adam",
                 rows_injection: Optional[bool] = None, packed_tables: bool = False,
                 packed_min_width: int = 64, packed_bytes: bool = False, packed_dtype=None,
                 table_lr: Optional[float] = None):
        if not hasattr(model, "sparse_table_ids"):
            raise TypeError(f"{type(model).__name__} does not implement sparse_table_ids()")
        if table_optimizer not in PACKED_COLS:
            raise ValueError(f"table_optimizer must be one of {sorted(PACKED_COLS)}, "
                             f"got {table_optimizer!r}")
        if packed_bytes:  # byte rows are a packed layout
            packed_tables = True
        if packed_tables:
            if rows_injection is False:
                raise ValueError("packed_tables requires the rows-injection path")
            rows_injection = True
        if packed_dtype is not None:
            if not packed_tables or packed_bytes:
                raise ValueError("packed_dtype needs packed_tables=True (f32-exact byte rows are "
                                 "the packed_bytes option)")
            if packed_dtype not in _STORAGE:
                raise ValueError(f"packed_dtype must be float32 or bfloat16, got {packed_dtype!r}")
            packed_dtype = _STORAGE[packed_dtype]
        super().__init__(model, device)
        self.table_optimizer = table_optimizer
        self.rows_injection = rows_injection
        self.packed_tables = packed_tables
        self.packed_min_width = packed_min_width
        self.packed_bytes = packed_bytes
        self.packed_dtype = packed_dtype
        self._table_lr_override = table_lr
        self._table_lr: Optional[float] = None
        self._emb_dims: Dict[str, int] = {}
        self._table_paths: Tuple[str, ...] = ()
        # bf16 and byte rows: each table's [V, E] shape, the model's parameter being empty
        self._table_shapes: Dict[str, Tuple[int, int]] = {}

    def compile(self, *args, lr: float = 1e-3, **kwargs) -> None:
        """As ``Trainer.compile``; the table optimizer's lr comes from
        ``resolve_table_lr``."""
        super().compile(*args, lr=lr, **kwargs)
        self._table_lr = resolve_table_lr(self.model, self._table_lr_override, lr,
                                          rowwise_tables=self.table_optimizer == "rowwise_adagrad")

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _table_param(self, path: str) -> nn.Parameter:
        module_name, param_name = _module_path(path)
        return getattr(self.model.get_submodule(module_name), param_name)

    def _set_table_param(self, path: str, value: torch.Tensor) -> None:
        module_name, param_name = _module_path(path)
        setattr(self.model.get_submodule(module_name), param_name,
                nn.Parameter(value, requires_grad=False))

    def init_state(self, sample_batch: Batch, seed: int = 2020) -> SparseTrainState:
        """As ``Trainer.init_state``. A table that a bf16 or byte-row state
        emptied is given back its ``[V, E]`` shape first, so the draws are
        those of a fresh model."""
        for path, shape in self._table_shapes.items():
            self._set_table_param(path, torch.empty(shape, device=self.device))
        self._table_shapes = {}
        return super().init_state(sample_batch, seed)

    def _injects_all(self, sample_batch: Batch, declared: set) -> bool:
        """``rows_injection=None``'s resolution: every declared table takes
        rows through ``sharded_table_specs`` (which per-field tables lack)."""
        try:
            specs = self.model.sharded_table_specs(sample_batch)
        except ValueError:
            return False
        return declared <= {spec["path"] for spec in specs.values()}

    def _injection_specs(self, batch: Batch) -> Dict[str, dict]:
        """The trained tables' rows-injection specs for ``batch``."""
        if self.rows_injection:
            specs = self.model.sharded_table_specs(batch)
        else:
            specs = getattr(self.model, "injection_specs", self.model.sharded_table_specs)(batch)
        return {name: spec for name, spec in specs.items() if spec["path"] in self._table_paths}

    def _zero_moments(self, table: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.table_optimizer == "adam":
            return {"m": torch.zeros_like(table), "v": torch.zeros_like(table)}
        if self.table_optimizer == "rowwise_adagrad":
            return {"acc": table.new_zeros((table.shape[0],))}
        return {"acc": torch.zeros_like(table)}

    def _make_state(self, sample_batch: Batch, rng: torch.Generator) -> SparseTrainState:
        declared = set(self.model.sparse_table_ids(sample_batch))
        if self.rows_injection is None:
            self.rows_injection = self._injects_all(sample_batch, declared)
        self._table_paths = tuple(sorted(declared))
        specs = self._injection_specs(sample_batch)
        missing = declared - {spec["path"] for spec in specs.values()}
        if missing:
            raise ValueError(f"tables {sorted(missing)} cannot take injected rows")
        packed, moments = {}, {}
        for path in self._table_paths:
            table = self._table_param(path).detach()
            e = table.shape[1]
            self._emb_dims[path] = e
            if not self.packed_tables:
                self._table_param(path).requires_grad_(False)
                moments[path] = self._zero_moments(table)
                continue
            moments[path] = {}
            if self.packed_bytes:
                packed[path] = pack_table_bytes(table, self.table_optimizer, self.packed_min_width)
            else:
                packed[path] = pack_table(table, self.table_optimizer, self.packed_min_width,
                                          self.packed_dtype)
            if self.packed_bytes or self.packed_dtype is not None:
                self._table_shapes[path] = tuple(table.shape)
                self._set_table_param(path, table.new_empty((0, e)))
            else:  # the model reads the trained table through a view of the buffer
                self._set_table_param(path, unpack_table(packed[path], e))
        tables = {".".join(_module_path(p)) for p in self._table_paths}
        optimizer = self._build_optimizer((name, p) for name, p in self.model.named_parameters()
                                          if name not in tables)
        adam_tables = self._table_paths if self.table_optimizer == "adam" else ()
        return SparseTrainState(optimizer=optimizer, rng=rng, scalars=StepScalars(adam_tables),
                                packed=packed, table_moments=moments)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _f32_rows(self, rows: torch.Tensor, path: str) -> torch.Tensor:
        """The f32 table values of gathered packed rows: a strided view of
        f32 or byte rows, a converted copy of bf16 rows."""
        e = self._emb_dims[path]
        if self.packed_bytes:
            return unpack_table_bytes(rows, e)
        return unpack_table(rows, e).to(torch.float32)

    def _gather(self, path: str, ids: torch.Tensor) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """A table's rows at ``ids``: (the packed rows, None when unpacked;
        their f32 table values)."""
        if not self.packed_tables:
            return None, self._table_param(path).index_select(0, ids)
        rows = self.state.packed[path].index_select(0, ids)
        return rows, self._f32_rows(rows, path)

    def _update(self, path: str, ids: torch.Tensor, rows: Optional[torch.Tensor],
                grads: torch.Tensor, bias_correction: Optional[torch.Tensor]) -> None:
        """One table's row-sparse update, in place."""
        state, lr, optimizer = self.state, self._table_lr, self.table_optimizer
        if self.packed_tables:
            update = packed_sparse_update_bytes if self.packed_bytes else packed_sparse_update
            update(state.packed[path], rows, ids, grads, bias_correction, lr=lr,
                   optimizer=optimizer)
            return
        table, moments = self._table_param(path), state.table_moments[path]
        with torch.no_grad():
            if optimizer == "adam":
                sparse_lazy_adam(table, moments["m"], moments["v"], ids, grads, bias_correction,
                                 lr=lr)
            elif optimizer == "adagrad":
                sparse_adagrad(table, moments["acc"], ids, grads, lr=lr)
            else:
                sparse_rowwise_adagrad(table, moments["acc"], ids, grads, lr=lr)

    def _step(self, batch: Dict[str, torch.Tensor], scalars: torch.Tensor) -> torch.Tensor:
        """One step: each table's gather, forward with injected rows,
        backward, dense optimizer, each table's update, whose Adam bias
        corrections come from the step's scalars. Returns the loss (a device
        scalar)."""
        state = self.state
        injected = dict(batch)
        gathered = []
        for spec in self._injection_specs(batch).values():
            path = spec["path"]
            ids = spec["ids"].reshape(-1).to(torch.int32)
            rows, values = self._gather(path, ids)
            leaf = values.detach().requires_grad_()
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
            self._update(path, ids, rows, leaf.grad, bias_correction)
        return loss.detach()

    # ------------------------------------------------------------------
    # scoring, export and checkpoints
    # ------------------------------------------------------------------

    def _with_table_rows(self, batch: Batch) -> Batch:
        """``batch`` with the f32 rows of each bf16 or byte-row table
        injected (the model holds no copy of those tables)."""
        if not self._table_shapes:
            return batch
        out = dict(batch)
        for spec in self.model.sharded_table_specs(batch).values():
            path = spec["path"]
            if path in self._table_shapes:
                ids = spec["ids"].reshape(-1)
                out[spec["rows_key"]] = self._f32_rows(
                    self.state.packed[path].index_select(0, ids), path)
        return out

    def _score_body(self, inputs) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.model(self._with_table_rows(inputs.batch), train=False)

    def _score_eager(self, batch: Batch) -> torch.Tensor:
        with torch.inference_mode():
            prediction, _ = self.model(self._with_table_rows(self._to_device(batch)), train=False)
        return prediction

    def unpacked_params(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with every table as f32 ``[V, E]``: the
        model's own (unpacked), a view of its packed buffer's table columns
        (packed f32), or the buffer's columns as f32 (bf16: a copy; bytes: a
        view)."""
        self._assert_state()
        params = self.model.state_dict()
        for path in self._table_shapes:
            e = self._emb_dims[path]
            packed = self.state.packed[path]
            params[".".join(_module_path(path))] = (
                unpack_table_bytes(packed, e) if self.packed_bytes
                else unpack_table(packed, e).to(torch.float32))
        return params

    @contextlib.contextmanager
    def _serving_model(self) -> Iterator[nn.Module]:
        """The model with each packed table as a contiguous f32 ``[V, E]``
        copy (the export's plain gather model, as the JAX trainer exports
        its unpacked tables): a packed f32 table is a strided view of its
        ``[V, W]`` buffer, which the program would otherwise save whole, and
        bf16 and byte rows leave the model an empty table. The model's own
        tables are put back after."""
        if not self.packed_tables:
            yield self.model
            return
        self._assert_state()
        own = {path: self._table_param(path) for path in self.state.packed}
        try:
            for path, packed in self.state.packed.items():
                self._set_table_param(path, self._f32_rows(packed, path)
                                      .clone(memory_format=torch.contiguous_format))
            yield self.model
        finally:
            for path, table in own.items():
                module_name, param_name = _module_path(path)
                setattr(self.model.get_submodule(module_name), param_name, table)

    def make_serving_fn(self) -> Callable[[Batch], torch.Tensor]:
        """Scorer over the trained state: the model gathers from its tables
        (unpacked, or a view of the packed f32 buffers), or takes the f32
        rows of bf16 and byte rows injected."""
        self._assert_state()
        return super().make_serving_fn()

    def _extra_checkpoint(self) -> Dict[str, Any]:
        """A checkpoint's unpacked-table moments (host copies), by path."""
        return {"table_moments": {path: {k: v.detach().to("cpu", copy=True)
                                         for k, v in moments.items()}
                                  for path, moments in self.state.table_moments.items()}}

    def _load_extra_checkpoint(self, payload: Dict[str, Any]) -> None:
        """The moments copied into the state's tensors, in place."""
        saved, own = payload["table_moments"], self.state.table_moments
        if {p: set(m) for p, m in saved.items()} != {p: set(m) for p, m in own.items()}:
            raise KeyError(f"table moments {sorted(saved)}, the state has {sorted(own)}")
        with torch.no_grad():
            for path, moments in own.items():
                for key, tensor in moments.items():
                    tensor.copy_(saved[path][key])
