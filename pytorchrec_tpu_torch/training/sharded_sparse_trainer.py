"""The explicit sharded-embedding trainer (port of
``pytorchrec_tpu/training/sharded_sparse_trainer.py``): the multi-device
sparse path, on ``torch.distributed``, one process a rank.

``ShardedSparseEmbeddingTrainer(model, mesh, ...)`` keeps each table the
model's ``sharded_table_specs`` names (and its row-sparse optimizer state)
split by row over the mesh, every other parameter replicated, and takes a
step as the JAX trainer's ``shard_map`` body does, with each collective
written out (``parallel/embedding_engine.py``):

1. **lookup**: each table's batch ids ride the ``all_to_all`` exchange to
   their owners and the rows come back; they go into the model as leaves
   under the spec's batch key, so no table takes part in autograd and the
   gradient of the loss with respect to them is the exact per-occurrence
   row gradient;
2. **dense backward**: the replicated parameters' gradients are averaged
   over the data group (one ``all_reduce``, the loss in it; or the int8
   wire format with error feedback, ``grad_compression="int8"``,
   ``parallel/grad_compression.py``) and the dense optimizer steps;
3. **sparse backward**: the row gradients (scaled by ``1/d``: each rank's
   loss is the mean over its ``B/d`` rows) are routed back to their owners
   (``all_to_all_rowgrad``; padding carries a sentinel id), and the owner
   applies the unchanged row-sparse update to its rows: lazy Adam, Adagrad
   or rowwise Adagrad on unpacked rows, ``packed_sparse_update`` (B2, B4)
   on packed f32 or bf16 rows, ``packed_quantized_update`` (B2, B3, B4) on
   int8 byte rows keyed by global ids. Ids past the shard reach the update
   as one past its last row, which every update drops.

``strategy``:

* ``"1d"``: tables split over the model axis, whole along the data axis;
  the owners' row grads are gathered over the data group so every replica
  applies the same update;
* ``"grid"``: tables split over the whole ``(data, model)`` grid, one owner
  a row (``grid_lookup``/``grid_rowgrad``, or with ``two_hop=True`` the
  two-hop exchange, which sums duplicate ids between the hops with B2): no
  data-axis gather;
* ``"hot_cold"``: for each table with counts in ``hot_counts``
  (``{spec name: counts [V]}``), the hottest rows (``hot_rows``: an int, or
  a float in (0, 1), the share of the traffic) are replicated on every rank
  and updated there from the data group's gathered grads, the cold tail
  split over the model axis as under ``"1d"`` (``parallel/hot_cold.py``).

``exchange_capacity`` bounds the exchange's buckets (exact either way:
overflow rounds, read once per exchange); ``qgrad_exchange=True`` ships each
row grad as int8 and a scale on the backward exchange (not with ``two_hop``
or ``hot_cold``); ``packed_tables`` and ``packed_dtype="bfloat16"`` are the
sparse trainer's formats, kept per shard; a model with
``quantized_embedding=True, table_packed=True`` (DLRM, DCN-v2) trains its
int8 byte rows here too (``packed_tables=True``).

The state: ``state.packed`` and ``state.table_moments`` hold this rank's
rows (of the cold fragment under hot/cold), ``state.hot`` the hot fragments
(JAX's ``hot_tables/<path>`` leaves), ``state.grad_residual`` this data
index's residuals. ``leaves_of``, ``checkpoint_state`` and the saves gather
each table over its axis (collectives: every rank calls them), in the JAX
trainer's layout (hot/cold fragments, residuals ``[d, ...]``), and
``params_from_jax`` and the loads slice whole leaves; ``merged_params``
gives the one-process layout. Scoring (``evaluate``, ``predict``,
``make_serving_fn``) injects rows through the same lookups, eagerly, on
every rank.

Every step runs eagerly: the exchange reads its overflow flags on the host
and a gloo world cannot be captured, so ``fit_steps`` and ``fit`` run the
eager step body, on the card as on the CPU. Dropout draws per rank (JAX
folds the data index into the step's key): parity runs use nets without
dropout.

The step's and the scoring's forward passes run inside
``parallel.mesh.bound(mesh)``, as JAX's run inside ``shard_map``: a model
that names a mesh axis reaches the mesh there (the two-tower model's
``global_negatives_axis="data"``: its gather's backward sums the other
ranks' cotangents into this rank's injected item rows before the ``1/d``
scale and the exchange).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pytorchrec_tpu_torch.ops.embedding import normal_init
from pytorchrec_tpu_torch.ops.kernels.quantize import quantize_rows
from pytorchrec_tpu_torch.ops.quantized_packed import (
    dequant_packed_rows,
    pack_quantized_table,
    packed_quantized_update,
    q_row_bytes,
)
from pytorchrec_tpu_torch.ops.sparse_update import (
    bytes_to_f32,
    dedup_row_grads,
    f32_to_bytes,
    pack_table,
    packed_sparse_update,
    sparse_adagrad,
    sparse_lazy_adam,
    sparse_rowwise_adagrad,
    unpack_table,
)
from pytorchrec_tpu_torch.parallel.embedding_engine import (
    GRID,
    all_to_all_lookup,
    all_to_all_rowgrad,
    grid_lookup,
    grid_rowgrad,
    two_hop_lookup,
    two_hop_rowgrad,
)
from pytorchrec_tpu_torch.parallel.grad_compression import (
    DEFAULT_MIN_SIZE,
    compressed_pmean_flat,
    select_compressible,
)
from pytorchrec_tpu_torch.parallel.hot_cold import (
    HotColdLayout,
    build_layout,
    hot_cold_lookup,
    merge_table,
    split_table,
)
from pytorchrec_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, bound
from pytorchrec_tpu_torch.parallel.sharding import RowShard
from pytorchrec_tpu_torch.training.sparse_trainer import SparseEmbeddingTrainer, _module_path
from pytorchrec_tpu_torch.training.state import ShardedTrainState, StepScalars
from pytorchrec_tpu_torch.training.trainer import Batch
from pytorchrec_tpu_torch.utils.convert import _port_key, flax_path, leaves_of
from pytorchrec_tpu_torch.utils.rng import prng_key, split

HOT = "hot_tables/"  # the hot fragments' leaf prefix (JAX's)
_HOT_SALT = int(np.uint32(0x9E3779B9).view(np.int32))  # the hot fragment's salt xor


def resolve_hot_layouts(model, mesh: Mesh, sample_batch, flat_params, hot_counts, hot_budget,
                        table_paths, out_layouts) -> None:
    """Each table's ``HotColdLayout`` from ``hot_counts`` into
    ``out_layouts`` (idempotent; only the leaves' row counts are read):
    counts padded with -1 to the leaf's rows (padding rows are the coldest),
    the hot rows ``hot_budget`` (an int, or a float in (0, 1): the fewest
    rows holding that share of the counts), at least one and at most
    ``V - m``, so each model shard owns cold rows; the cold fragment padded
    to a multiple of ``m``."""
    if out_layouts:
        return
    m = mesh.model
    for name, spec in model.sharded_table_specs(sample_batch).items():
        path = spec["path"]
        if name not in hot_counts or path not in table_paths:
            continue
        v = flat_params[path].shape[0]
        counts = np.asarray(hot_counts[name], np.float64)
        if len(counts) > v:
            raise ValueError(f"{name}: {len(counts)} counts for a {v}-row table")
        if len(counts) < v:
            counts = np.concatenate([counts, np.full(v - len(counts), -1.0)])
        if isinstance(hot_budget, float) and 0 < hot_budget < 1:
            ranked = np.sort(np.maximum(counts, 0))[::-1]
            total = ranked.sum()
            h = (int(np.searchsorted(np.cumsum(ranked), hot_budget * total) + 1)
                 if total > 0 else 0)
        else:
            h = int(hot_budget)
        h = max(1, min(h, v - m))
        out_layouts[path] = build_layout(counts, h, pad_cold_to_multiple=m)


def split_hot_cold(flat: Dict[str, torch.Tensor], moments: Dict[str, dict],
                   layouts: Dict[str, HotColdLayout], packed_tables: bool,
                   table_optimizer: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, dict]]:
    """Replace each hot/cold table leaf ``[V, X]`` (whole) with its cold
    fragment ``[C, X]`` (zero padding rows) and add the hot fragment under
    ``hot_tables/<path>``; the moments follow the fragments (packed rows
    carry theirs)."""
    for path, layout in layouts.items():
        leaf = flat[path]
        h, c = layout.hot_rows, layout.cold_rows
        flat[HOT + path], flat[path] = split_table(leaf, layout)
        cold = flat[path]
        if packed_tables:
            moments[path] = {}
        elif table_optimizer == "adam":
            moments[path] = {"m": torch.zeros_like(cold), "v": torch.zeros_like(cold),
                             "hot_m": leaf.new_zeros((h, leaf.shape[1])),
                             "hot_v": leaf.new_zeros((h, leaf.shape[1]))}
        elif table_optimizer == "rowwise_adagrad":
            moments[path] = {"acc": leaf.new_zeros((c,)), "hot_acc": leaf.new_zeros((h,))}
        else:
            moments[path] = {"acc": torch.zeros_like(cold),
                             "hot_acc": leaf.new_zeros((h, leaf.shape[1]))}
    return flat, moments


def _flax_layout(path: str, tensor: torch.Tensor) -> torch.Tensor:
    """A dense leaf's tensor in the flax layout (a kernel ``[in, out]``, the
    port's ``[out, in]`` transposed), or back: the same transpose."""
    return tensor.t() if _port_key(path)[1] == "transpose" else tensor


class ShardedSparseEmbeddingTrainer(SparseEmbeddingTrainer):
    """``SparseEmbeddingTrainer`` whose tables are split over the mesh and
    whose lookups and row gradients go through the explicit all-to-all
    engine (see the module docstring)."""

    trains_quantized_tables = True

    def __init__(self, model, mesh: Mesh, table_optimizer: str = "adam", strategy: str = "1d",
                 grad_compression: Optional[str] = None,
                 grad_compression_min_size: Optional[int] = None, hot_counts=None,
                 hot_rows=0.9, exchange_capacity=None, packed_tables: bool = False,
                 packed_min_width: int = 64, two_hop: bool = False, packed_dtype=None,
                 qgrad_exchange: bool = False, table_lr: Optional[float] = None):
        if mesh is None:
            raise ValueError("ShardedSparseEmbeddingTrainer requires a mesh")
        if strategy not in ("1d", "grid", "hot_cold"):
            raise ValueError(f"strategy must be 1d, grid or hot_cold, got {strategy!r}")
        if qgrad_exchange and two_hop:
            raise ValueError("qgrad_exchange does not compose with two_hop (in-transit sums)")
        if qgrad_exchange and strategy == "hot_cold":
            raise ValueError("qgrad_exchange does not compose with hot_cold")
        if grad_compression not in (None, "int8"):
            raise ValueError(f"grad_compression must be None or 'int8', got {grad_compression!r}")
        if strategy == "grid":
            if mesh.model * mesh.data <= 1:
                raise ValueError("the grid strategy needs more than one rank")
        elif mesh.model <= 1:
            raise ValueError(f"mesh needs a model axis > 1, got {mesh.shape} (use "
                             "SparseEmbeddingTrainer for pure data-parallel)")
        if not hasattr(model, "sharded_table_specs"):
            raise TypeError(f"{type(model).__name__} does not implement sharded_table_specs()")
        if two_hop and strategy != "grid":
            raise ValueError("two_hop applies to the grid strategy only")
        if strategy == "hot_cold" and not hot_counts:
            raise ValueError("strategy='hot_cold' needs hot_counts={name: counts}")
        super().__init__(model, table_optimizer=table_optimizer,
                         rows_injection=True, packed_tables=packed_tables,
                         packed_min_width=packed_min_width, packed_dtype=packed_dtype,
                         table_lr=table_lr, mesh=mesh)
        self.strategy = strategy
        self.grad_compression = grad_compression
        self.grad_compression_min_size = grad_compression_min_size
        self.exchange_capacity = exchange_capacity
        self.two_hop = two_hop
        self.qgrad_exchange = qgrad_exchange
        self._hot_counts = dict(hot_counts or {})
        self._hot_budget = hot_rows
        self._hot_layouts: Dict[str, HotColdLayout] = {}
        self._hot_perms: Dict[str, torch.Tensor] = {}
        self._q_info: Dict[str, dict] = {}

    # ------------------------------------------------------------------
    # state layout
    # ------------------------------------------------------------------

    @property
    def _axis(self):
        """The tables' mesh axis: the grid's, or the model axis."""
        return GRID if self.strategy == "grid" else MODEL_AXIS

    def _specs(self, batch: Batch) -> Dict[str, dict]:
        """The trained tables' specs for ``batch``."""
        return {name: spec for name, spec in self.model.sharded_table_specs(batch).items()
                if spec["path"] in self._table_paths}

    def _whole_leaf(self, path: str, rng: torch.Generator) -> torch.Tensor:
        """A table's whole starting leaf: packed rows (f32, bf16, or int8
        bytes drawn as ``QuantizedEmbeddingTrainer`` draws them), or the
        model's ``[V, E]`` table."""
        info = self._q_info.get(path)
        if info is not None:
            v = self._table_param(path).shape[0]
            q, scale = quantize_rows(normal_init((v, info["emb_size"]), self.device, rng),
                                     bits=info["bits"], col_groups=info["col_groups"])
            acc = torch.zeros((v,), dtype=torch.float32, device=self.device)
            return pack_quantized_table(q, scale, acc, info["emb_size"], info["bits"],
                                        info["col_groups"])
        table = self._table_param(path).detach()
        if self.packed_tables:
            return pack_table(table, self.table_optimizer, self.packed_min_width,
                              self.packed_dtype)
        return table

    def _make_state(self, sample_batch: Batch, rng: torch.Generator) -> ShardedTrainState:
        mesh = self.mesh
        specs = self.model.sharded_table_specs(sample_batch)
        self._q_info = {spec["path"]: dict(spec["quantized"]) for spec in specs.values()
                        if spec.get("quantized")}
        if self._q_info and not self.packed_tables:
            raise ValueError("sharded quantized tables require packed_tables=True (the packed "
                             "machinery carries the byte rows)")
        self._table_paths = tuple(sorted({spec["path"] for spec in specs.values()}))
        key = split(prng_key(rng.initial_seed()))[1]
        whole, moments = {}, {}
        for path in self._table_paths:
            original = self._table_param(path)
            self._full_shapes[path] = torch.empty_like(original, device="meta")
            self._emb_dims[path] = (self._q_info[path]["emb_size"] if path in self._q_info
                                    else original.shape[1])
            whole[path] = self._whole_leaf(path, rng)
            moments[path] = {} if self.packed_tables else self._zero_moments(whole[path])
        if self.strategy == "hot_cold":
            resolve_hot_layouts(self.model, mesh, sample_batch, whole, self._hot_counts,
                                self._hot_budget, self._table_paths, self._hot_layouts)
            whole, moments = split_hot_cold(whole, moments, self._hot_layouts,
                                            self.packed_tables, self.table_optimizer)
            self._hot_perms = {p: torch.from_numpy(lo.perm).to(self.device)
                               for p, lo in self._hot_layouts.items()}
        n, index = mesh.axis_size(self._axis), mesh.axis_index(self._axis)
        packed, hot = {}, {}
        for path in self._table_paths:
            leaf = whole[path]
            if leaf.shape[0] % n:
                raise ValueError(f"{path}: {leaf.shape[0]} rows not divisible by the {n} table "
                                 "shards; set the model's table_row_multiple")
            rps = leaf.shape[0] // n
            shard = self._shards[path] = RowShard(leaf.shape[0], rps, index * rps, self._axis)
            local = shard.local(leaf).clone()
            moments[path] = {k: v if k.startswith("hot_") else shard.local(v).clone()
                             for k, v in moments[path].items()}
            if HOT + path in whole:
                hot[path] = whole[HOT + path]
            if path in self._q_info:
                self._set_leaf(path, local)
                packed[path] = self._table_param(path)
            elif not self.packed_tables:
                self._set_table_param(path, local)
            else:
                packed[path] = local
                if self.packed_dtype is not None:
                    self._table_shapes[path] = tuple(self._full_shapes[path].shape)
                    self._set_table_param(path, local.new_empty((0, self._emb_dims[path])))
                else:
                    self._set_table_param(path, unpack_table(local, self._emb_dims[path]))
        tables = {".".join(_module_path(p)) for p in self._table_paths}
        dense = [(name, p) for name, p in self.model.named_parameters() if name not in tables]
        optimizer = self._build_optimizer(dense)
        residual = {}
        if self.grad_compression is not None:
            min_size = (DEFAULT_MIN_SIZE if self.grad_compression_min_size is None
                        else self.grad_compression_min_size)
            residual = select_compressible({flax_path(name): p.detach() for name, p in dense},
                                           min_size=min_size)
        adam_tables = [p for p in self._table_paths
                       if p not in self._q_info] if self.table_optimizer == "adam" else []
        scalars = StepScalars(adam_tables, salted_tables=list(self._q_info),
                              rng_key=key if self._q_info else None)
        return ShardedTrainState(optimizer=optimizer, rng=rng, scalars=scalars, packed=packed,
                                 table_moments=moments, hot=hot, grad_residual=residual,
                                 rng_key=key)

    # ------------------------------------------------------------------
    # lookups
    # ------------------------------------------------------------------

    def _storage(self, path: str) -> torch.Tensor:
        """This rank's rows of a table (of its cold fragment)."""
        if self.packed_tables:
            return self.state.packed[path]
        return self._table_param(path).detach()

    def _out_cols(self, path: str) -> Optional[int]:
        """Columns a looked-up row ships on the return hop: the q || scale
        bytes of int8 rows (the wire never carries dequantized f32), E of
        packed rows, the whole row otherwise."""
        info = self._q_info.get(path)
        if info is not None:
            return q_row_bytes(info["emb_size"], info["bits"]) + 4 * info["col_groups"]
        return self._emb_dims[path] if self.packed_tables else None

    def _model_rows(self, path: str, raw: torch.Tensor) -> torch.Tensor:
        """Wire rows -> the model's f32 rows."""
        info = self._q_info.get(path)
        if info is not None:
            return dequant_packed_rows(raw, info["emb_size"], info["bits"], info["col_groups"])
        return raw.to(torch.float32)

    def _lookup(self, path: str, ids: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """A table's wire rows at the data index's ``ids`` (and the hot/cold
        lookup's aux)."""
        table, cap, oc = self._storage(path), self.exchange_capacity, self._out_cols(path)
        layout = self._hot_layouts.get(path)
        if layout is not None:
            return hot_cold_lookup(self.state.hot[path], table, self._hot_perms[path], ids,
                                   self.mesh, capacity=cap, out_cols=oc, with_aux=True)
        if self.strategy == "grid" and self.two_hop:
            return two_hop_lookup(table, ids, self.mesh, GRID, capacity2=cap, out_cols=oc), None
        if self.strategy == "grid":
            return grid_lookup(table, ids, self.mesh, GRID, capacity=cap, out_cols=oc), None
        return all_to_all_lookup(table, ids, self.mesh, MODEL_AXIS, capacity=cap,
                                 out_cols=oc), None

    def _with_table_rows(self, batch: Batch) -> Batch:
        """``batch`` with every table's rows injected, looked up over the
        mesh (the model holds only this rank's rows)."""
        out = dict(batch)
        with torch.no_grad():
            for spec in self._specs(batch).values():
                raw, _ = self._lookup(spec["path"], spec["ids"].reshape(-1).to(torch.int32))
                out[spec["rows_key"]] = self._model_rows(spec["path"], raw)
        return out

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _captures(self) -> bool:
        """Never: the exchange reads its overflow flags on the host and a
        gloo world cannot be captured, so ``fit_steps`` and ``fit`` run the
        eager step body, on the card as on the CPU."""
        return False

    def _eval_step(self, batch: Batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(prediction, target)`` of a global batch, eagerly: each data
        index scores its rows (rows injected over the mesh), the scores are
        gathered over the data group."""
        local = self._to_device(self._local_batch(batch))
        with torch.inference_mode(), bound(self.mesh):
            prediction, target = self.model(self._with_table_rows(local), train=False)
        return self._gathered(prediction), None if target is None else self._gathered(target)

    def _score_eager(self, batch: Batch) -> torch.Tensor:
        with bound(self.mesh):
            return super()._score_eager(batch)

    def _mean_dense_grads(self, loss: torch.Tensor) -> torch.Tensor:
        """Every dense gradient and the loss averaged over the data group:
        one ``all_reduce``, or with int8 compression each residual's leaf
        through ``compressed_pmean_flat`` (its residual updated in place)
        and the rest, the loss first, in one ``all_reduce``."""
        if self.grad_compression is None:
            return self._average_over_data(loss)
        state = self.state
        names = {id(p): flax_path(name) for name, p in self.model.named_parameters()}
        params = {names[id(p)]: p for group in state.optimizer.param_groups
                  for p in group["params"] if p.grad is not None}
        grads = {"": loss.detach().reshape(1), **{k: p.grad for k, p in params.items()}}
        residual = {k: r for k, r in state.grad_residual.items() if k in params}
        means, new_res = compressed_pmean_flat(grads, residual, self.mesh, DATA_AXIS)
        for path, p in params.items():
            p.grad.copy_(means[path])
        for path, r in new_res.items():
            state.grad_residual[path].copy_(r)
        return means[""][0]

    def _qgrad_pack(self, g: torch.Tensor) -> torch.Tensor:
        """[n, E] f32 -> [n, E + 4] u8: each row's int8 values (round to
        nearest) and its f32 scale's bytes."""
        q, s = quantize_rows(g, bits=8)
        return torch.cat([q.view(torch.uint8), f32_to_bytes(s[:, None])], dim=1)

    @staticmethod
    def _qgrad_unpack(p: torch.Tensor, e: int) -> torch.Tensor:
        q = p[:, :e].contiguous().view(torch.int8)
        s = bytes_to_f32(p[:, e:e + 4].contiguous())[:, 0]
        return q.to(torch.float32) * s[:, None]

    def _step(self, batch: Dict[str, torch.Tensor], scalars: torch.Tensor) -> torch.Tensor:
        """One step: lookups, forward with the injected rows, backward, the
        dense mean and optimizer, each table's exchange and update. Returns
        the loss (a device scalar, the data group's mean)."""
        state = self.state
        injected = dict(batch)
        gathered = []
        for spec in self._specs(batch).values():
            path = spec["path"]
            ids = spec["ids"].reshape(-1).to(torch.int32)
            with torch.no_grad():
                raw, aux = self._lookup(path, ids)
            leaf = self._model_rows(path, raw).detach().requires_grad_()
            injected[spec["rows_key"]] = leaf
            gathered.append((path, ids, leaf, aux))

        with bound(self.mesh):
            prediction, target = self.model(injected, train=True, generator=state.rng)
        loss = self.loss_fn(prediction, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = self._mean_dense_grads(loss)
        state.optimizer.step()
        inv_data = 1.0 / self.mesh.data
        with torch.no_grad():
            for path, ids, leaf, aux in gathered:
                self._update_table(path, ids, leaf.grad * inv_data, aux, scalars)
        return loss.detach()

    def _bias(self, scalars: torch.Tensor, path: str) -> Optional[torch.Tensor]:
        """The step's Adam bias corrections of table ``path`` (None for the
        other optimizers)."""
        if self.table_optimizer != "adam":
            return None
        return self.state.scalars.bias_correction(scalars, path)

    def _apply(self, path: str, table: torch.Tensor, moments: Dict[str, torch.Tensor],
               prefix: str, ids: torch.Tensor, grads: torch.Tensor, scalars: torch.Tensor,
               offset: int = 0, salt: Optional[torch.Tensor] = None) -> None:
        """One shard's (or fragment's) update, in place: ``ids`` are its rows,
        those past it one past its last row (dropped). Packed rows take the
        pre-update rows at ``ids``; unpacked rows their moments
        ``moments[prefix + name]``."""
        lr, opt = self._table_lr, self.table_optimizer
        rows_here = table.shape[0]
        ids = torch.clamp(ids, max=rows_here).to(torch.int32)
        if self.packed_tables:
            rows = table.index_select(0, torch.clamp(ids, max=rows_here - 1))
            info = self._q_info.get(path)
            if info is not None:
                packed_quantized_update(table, rows, ids, grads, None, lr, bits=info["bits"],
                                        col_groups=info["col_groups"], rng_salt=salt,
                                        ids_offset=offset)
                return
            bias = self._bias(scalars, path)
            packed_sparse_update(table, rows, ids, grads, bias, lr=lr, optimizer=opt)
            return
        if opt == "adam":
            sparse_lazy_adam(table, moments[prefix + "m"], moments[prefix + "v"], ids, grads,
                             self._bias(scalars, path), lr=lr)
        elif opt == "adagrad":
            sparse_adagrad(table, moments[prefix + "acc"], ids, grads, lr=lr)
        else:
            sparse_rowwise_adagrad(table, moments[prefix + "acc"], ids, grads, lr=lr)

    def _update_table(self, path: str, ids: torch.Tensor, g_occ: torch.Tensor, aux,
                      scalars: torch.Tensor) -> None:
        """A table's backward exchange and update (the JAX step's order of
        collectives, the same on every rank)."""
        mesh, cap = self.mesh, self.exchange_capacity
        table, shard = self._storage(path), self._shards[path]
        rps = shard.rows_per_shard
        moments = self.state.table_moments.get(path, {})
        info = self._q_info.get(path)
        salt = self.state.scalars.salt(scalars, path) if info is not None else None
        layout = self._hot_layouts.get(path)
        if layout is not None:
            h = layout.hot_rows
            packed_ids, is_hot = aux
            cold_ids = torch.where(is_hot, mesh.model * rps, packed_ids - h)
            r_ids, r_rows = all_to_all_rowgrad(cold_ids, g_occ, rps, mesh, MODEL_AXIS,
                                               capacity=cap)
            hot_ids = torch.where(is_hot, packed_ids, h)
            if not self.packed_tables:  # dedup before the data-axis gathers
                g, gh = dedup_row_grads(r_ids, r_rows), dedup_row_grads(hot_ids, g_occ,
                                                                        pad_id_base=h)
                r_ids, r_rows, hot_ids, g_occ = g.ids, g.rows, gh.ids, gh.rows
            c_ids = mesh.all_gather(r_ids, DATA_AXIS)
            c_rows = mesh.all_gather(r_rows, DATA_AXIS)
            h_ids = mesh.all_gather(hot_ids, DATA_AXIS)
            h_rows = mesh.all_gather(g_occ, DATA_AXIS)
            self._apply(path, table, moments, "", c_ids - shard.offset, c_rows, scalars,
                        offset=shard.offset, salt=salt)
            hot_salt = None if salt is None else torch.bitwise_xor(salt, salt.new_tensor(_HOT_SALT))
            self._apply(path, self.state.hot[path], moments, "hot_", h_ids, h_rows, scalars,
                        salt=hot_salt)
            return
        e = g_occ.shape[1]
        q_wire = self.qgrad_exchange and e > 4
        send = self._qgrad_pack(g_occ) if q_wire else g_occ
        if self.strategy == "grid":
            exchange = two_hop_rowgrad if self.two_hop else grid_rowgrad
            cap_kw = {"capacity2": cap} if self.two_hop else {"capacity": cap}
            a_ids, a_pay = exchange(ids, send, rps, mesh, GRID, **cap_kw)
            a_rows = self._qgrad_unpack(a_pay, e) if q_wire else a_pay
            if not self.packed_tables:
                g = dedup_row_grads(a_ids, a_rows)
                a_ids, a_rows = g.ids, g.rows
        else:
            r_ids, r_pay = all_to_all_rowgrad(ids, send, rps, mesh, MODEL_AXIS, capacity=cap)
            if self.packed_tables:  # the update's own sort and scan combine duplicates
                a_ids = mesh.all_gather(r_ids, DATA_AXIS)
                a_pay = mesh.all_gather(r_pay, DATA_AXIS)
                a_rows = self._qgrad_unpack(a_pay, e) if q_wire else a_pay
            else:  # dedup before the data-axis gather (its payload m-fold smaller)
                r_rows = self._qgrad_unpack(r_pay, e) if q_wire else r_pay
                g = dedup_row_grads(r_ids, r_rows)
                a_ids = mesh.all_gather(g.ids, DATA_AXIS)
                a_rows = mesh.all_gather(g.rows, DATA_AXIS)
        self._apply(path, table, moments, "", a_ids - shard.offset, a_rows, scalars,
                    offset=shard.offset, salt=salt)

    # ------------------------------------------------------------------
    # leaves, checkpoints, the merged tables
    # ------------------------------------------------------------------

    def _held_leaves(self) -> Dict[str, torch.Tensor]:
        """The hot fragments, ``hot_tables/<path>`` (replicated)."""
        return {HOT + path: tensor for path, tensor in self.state.hot.items()}

    def _extra_checkpoint(self) -> Dict[str, Any]:
        """The table moments whole (hot ones as they are), the residuals of
        every data index (``[d, ...]``, JAX's ``grad_residual``) and the
        state's key."""
        state = self.state
        moments = {path: {k: (v.detach().to("cpu", copy=True) if k.startswith("hot_")
                              else self._full_rows(path, v)) for k, v in entry.items()}
                   for path, entry in state.table_moments.items()}
        residual = {path: self.mesh.all_gather(_flax_layout(path, r.detach())[None],
                                               DATA_AXIS).cpu()
                    for path, r in state.grad_residual.items()}
        return {"table_moments": moments, "grad_residual": residual,
                "rng_key": [int(word) for word in state.rng_key]}

    def _load_extra_checkpoint(self, payload: Dict[str, Any]) -> None:
        state = self.state
        saved = payload["table_moments"]
        if {p: set(m) for p, m in saved.items()} != {p: set(m) for p, m in
                                                      state.table_moments.items()}:
            raise KeyError(f"table moments {sorted(saved)}, the state has "
                           f"{sorted(state.table_moments)}")
        if set(payload["grad_residual"]) != set(state.grad_residual):
            raise KeyError(f"residuals {sorted(payload['grad_residual'])}, the state has "
                           f"{sorted(state.grad_residual)}")
        with torch.no_grad():
            for path, entry in state.table_moments.items():
                for key, tensor in entry.items():
                    value = saved[path][key]
                    tensor.copy_(value if key.startswith("hot_") else
                                 self._local_rows(path, value))
            for path, tensor in state.grad_residual.items():
                tensor.copy_(_flax_layout(path, payload["grad_residual"][path][
                    self.mesh.data_index]))
        state.rng_key = state.scalars.rng_key = np.array(payload["rng_key"], dtype=np.uint32)

    def merged_params(self) -> Dict[str, torch.Tensor]:
        """Host copies of the leaves by flax path in the one-process layout:
        each hot/cold pair merged back to ``[V, ...]`` in the original row
        order, packed f32 and bf16 tables as their f32 ``[V, E]`` table
        (int8 byte rows as they are, the model's format). A collective:
        every rank calls it."""
        leaves = leaves_of(self)
        for path in self._table_paths:
            table = leaves[path]
            layout = self._hot_layouts.get(path)
            if layout is not None:
                table = merge_table(leaves.pop(HOT + path), table, layout)
            if self.packed_tables and path not in self._q_info:
                table = table[:, :self._emb_dims[path]].to(torch.float32)
            leaves[path] = table
        return leaves

    def unpacked_params(self):
        raise NotImplementedError("a sharded trainer's tables are split over the mesh: "
                                  "merged_params() gives them whole")

