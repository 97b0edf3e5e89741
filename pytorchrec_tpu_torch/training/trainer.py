"""Trainer (port of ``pytorchrec_tpu/training/trainer.py``): compile,
init_state, train_step, fit, fit_steps, evaluate, predict, serving, and
weights and checkpoints.

``Trainer(model, device=None, packed_transfer=None, mesh=None)`` places the
model on the card (or on the CPU when asked; on a mesh, on its rank's
device: see the end of this docstring). ``compile(optimizer, loss, lr,
weight_decay, grad_clip_norm, matmul_precision, **optimizer_kwargs)`` picks
the dense optimizer (``optim/optimizers.py``), the loss and the train
step's matmul precision (``ops/precision.py``: ``"bfloat16"``
runs the step's dense products on bf16 operands with f32 results; serving
stays f32);
``init_state(sample_batch, seed)`` draws every parameter from a
``torch.Generator`` seeded with ``seed`` (normal(0, 0.01), the framework's
init, but where a module has its own, as flax does: ``init_parameters``)
and builds the optimizer; ``train_step(batch)`` runs one eager
forward, backward and optimizer step and returns the loss;
``fit(reader, batch_size, epochs, ...)`` trains epochs over a reader's
train split with the dev metrics between them and the callbacks' hooks
(``training/callbacks.py``), as the JAX trainer's ``fit`` does;
``fit_steps(batches, steps, log_every, steps_per_call=K)`` runs ``steps``
steps over any batch iterator and logs the loss at the end of each
``log_every`` window. ``make_serving_fn()`` returns the scorer
``fn(batch) -> prediction``; ``evaluate(reader, split, ...)`` the metrics
chosen at ``compile`` over a split, and ``predict(reader, split, ...)`` its
predictions.

The JAX trainer never runs a step eagerly: it jits one pure step over a
donated state, over the packed batch (``packed_transfer``, the default on
one device: one int32 and one float32 buffer a batch, ``data/packing.py``),
and with ``steps_per_call = K`` fuses K steps into one device call with
``lax.scan``. The port's twin is a CUDA graph. On the card ``fit`` and
``fit_steps`` pack each batch on the prefetch thread
(``data/prefetch.py``), copy it into static device buffers on the compute
stream, write each step's scalars (``state.py::StepScalars``) beside it,
and replay a graph that captured K steps over those buffers
(``_StepGraph``): one step of a new batch layout first runs eagerly, as a
real step (the warm-up: optimizer state, cuBLAS handles, kernel
attributes), the graph of K steps is captured right after it, and the
shorter tail's at its first use; every later call replays. The static
inputs and graphs are kept a layout each, for the last ``MAX_LAYOUTS``
layouts (``_Layout``), as JAX's jit cache keeps a compiled step a shape:
an epoch that ends on a shorter batch warms up and captures that batch's
layout once, and from the second epoch on ``fit`` only replays. The
parameters, optimizer state and tables are updated in place, so a replay
reads and writes them where the capture found them. A capture or a replay
that fails raises; nothing returns to eager steps. On the CPU the same step
bodies run eagerly over the same buffers, as they do on the card while
autograd's anomaly mode is on (``utils/profiling.py::
enable_nan_debugging``). ``train_step`` stays the eager single step on both.

Scoring is the JAX trainer's jitted ``_eval_step`` and ``make_serving_fn``:
``model(batch, train=False)`` under ``torch.inference_mode()``, one CUDA
graph a request signature (keys, shapes and dtypes, ``request_signature``)
over static inputs that hold the packed batch (``utils/graphs.py``): the
first request of a signature runs eagerly, the second captures, and every
later one replays. The prediction (and the target, where the batch has a
label) is copied out before it is returned. The tables that training writes
in place are what a replay reads, so a graph scores the current state;
``init_state`` drops the graphs. ``serve.eager`` (on ``make_serving_fn``'s
scorer) runs the same model call eagerly, without static inputs, for
comparison.

Export, the twin of the JAX trainer's ``export_serving``/``load_serving``:
``export_program(sample_batch)`` runs ``torch.export`` on the eager scorer
(``model(batch, train=False)`` under ``torch.no_grad()``, over the current
parameters, not through a captured graph), with shapes fixed to the sample
batch's. The scoring kernels stay ops of the graph
(``torch.ops.pytorchrec``). The program takes only the batch keys whose
values reach the scores, in sorted key order (the label is dropped), as
``jax.export`` keeps its inputs. ``export_serving`` saves it with
``torch.export.save``, the kept keys beside it; ``load_serving`` reads it
back without the model code and returns a scorer on the device it was
exported on. ``serving/bundle.py`` compiles the same program with
AOTInductor for the Python-free server.

Weights and checkpoints restore in place. ``save_weights`` writes the
leaves of ``utils/convert.py::leaves_of`` (keyed by flax path: the dense
parameters, each packed table's whole rows, a classic table's ``q`` and
``scale``) with ``torch.save`` to a temporary file renamed over the target;
``save_checkpoint`` adds the dense optimizer's state (keyed by its
parameter's flax path), the step, the dropout generator's state and
(``QuantizedEmbeddingTrainer``) the accumulators and the rounding key.
``load_weights``, ``load_best_weights`` and ``restore_checkpoint`` copy
every value into the tensor that holds it: the captured train graphs and
scorer graphs read those tensors' addresses, and some tables are views of
others (a sparse trainer's table is a view of its packed buffer, a
quantized trainer's packed table is the model's buffer). ``best_params``
is a host copy, as the JAX trainer keeps it. Files hold only what
``torch.load(weights_only=True)`` reads.

Batches are dicts of numpy arrays or tensors.

On a mesh (``mesh=``, ``parallel/mesh.py``; one process a rank, every rank
running the same calls on the same batches) the trainer is the JAX
trainer's sharded one, with its collectives written out:

* ``init_state`` draws the whole state from the seed, as one process does,
  and each rank keeps its rows of every table the rule shards over the
  model axis (``parallel/sharding.py``; the ``Embedding`` module then looks
  up through ``masked_psum_lookup``) and of that table's optimizer state;
* every rank reads the same global batch, and data index i keeps rows
  ``[i B/d, (i+1) B/d)`` of it (``data_sharding``); the packed transfer is
  off by default, as in the JAX trainer;
* after the backward each dense gradient and the step's loss are averaged
  over the data group (one ``all_reduce``); the model group already holds
  equal dense gradients. ``grad_clip_norm``'s global norm adds the table
  shards' squares over the model group;
* ``evaluate``, ``predict`` and the scorer score each data index's rows and
  gather the scores over the data group, so every rank returns the same;
* the weights, ``checkpoint_state`` and ``leaves_of`` gather each sharded
  table over the model group, rank 0 alone writes a file (``writes_files``,
  the one-process format) and every rank waits for it; a load on the same
  mesh keeps each rank's rows. Every rank must reach each save.

On the card the captured step holds the collectives with the rest of the
step; ``make_mesh`` made each group's communicator first. A rank's dropout
masks are drawn for its rows alone, so they differ from one process's.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import OrderedDict
from itertools import chain, islice
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from pytorchrec_tpu_torch.data.loader import eval_batches, num_train_batches, train_batches
from pytorchrec_tpu_torch.data.packing import BatchPacker, batch_signature
from pytorchrec_tpu_torch.data.prefetch import PackedBatch, device_put_prefetch
from pytorchrec_tpu_torch.data.schema import TrainMode
from pytorchrec_tpu_torch.loss import get_loss
from pytorchrec_tpu_torch.metric import MetricList
from pytorchrec_tpu_torch.metric.metrics import MSE, LogLoss, TaskSlice
from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.ops.embedding import INIT_STD, Embedding
from pytorchrec_tpu_torch.ops.kernels import add_tally, capture_tally
from pytorchrec_tpu_torch.ops.precision import check_precision, matmul_precision as precision_scope
from pytorchrec_tpu_torch.optim import build_optimizer, get_optimizer
from pytorchrec_tpu_torch.parallel.embedding_engine import owned_ids
from pytorchrec_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, data_sharding
from pytorchrec_tpu_torch.parallel.sharding import RowShard, param_shardings
from pytorchrec_tpu_torch.training.callbacks import Callback, CallbackList, History
from pytorchrec_tpu_torch.training.checkpoint import atomic_save
from pytorchrec_tpu_torch.training.state import TrainState
from pytorchrec_tpu_torch.utils.convert import _port_key, flax_path, leaves_of, load_leaves
from pytorchrec_tpu_torch.utils.device import resolve_device
from pytorchrec_tpu_torch.utils.graphs import GraphCache, StaticInputs, collector_paused

Batch = Dict[str, Any]

PREFETCH = 2  # batches the prefetch thread packs ahead (the JAX trainer's size)
MAX_LAYOUTS = 4  # batch layouts whose static inputs and graphs a trainer keeps


SERVING_META = "pytorchrec_serving.json"  # an exported program's kept keys and device


class ServingModule(torch.nn.Module):
    """``model``'s eager scores over batch columns given in ``keys``' order:
    the module ``Trainer.export_program`` exports."""

    def __init__(self, model: RecModel, keys: Sequence[str]):
        super().__init__()
        self.model = model
        self.keys = tuple(keys)

    def forward(self, *columns: torch.Tensor) -> torch.Tensor:
        prediction, _ = self.model(dict(zip(self.keys, columns)), train=False)
        return prediction


def _export_scorer(model: RecModel, batch: Dict[str, torch.Tensor],
                   keys: Sequence[str]) -> "torch.export.ExportedProgram":
    return torch.export.export(ServingModule(model, keys), tuple(batch[k] for k in keys))


def _kept_keys(program: "torch.export.ExportedProgram", keys: Sequence[str]) -> List[str]:
    """The keys whose placeholders reach the program's output."""
    nodes = list(program.graph.nodes)
    live, stack = set(), [n for n in nodes if n.op == "output"]
    while stack:
        for arg in stack.pop().all_input_nodes:
            if arg not in live:
                live.add(arg)
                stack.append(arg)
    reaching = {n.name for n in live if n.op == "placeholder"}
    return [k for k, name in zip(keys, program.graph_signature.user_inputs) if name in reaching]


class _StepInputs:
    """The static device buffers that one batch layout's steps read, ``rows``
    steps deep: the packed batches ``ints [rows, I]`` and ``floats [rows, F]``
    (or, unpacked, one batch's tensors by key), the step scalars
    ``[rows, n]`` and the losses ``[rows]``. Step i of a call reads row i."""

    def __init__(self, rows: int, device: torch.device, scalar_width: int,
                 packer: Optional[BatchPacker], example: Batch):
        self.rows, self.packer = rows, packer
        if packer is not None:
            self.ints = torch.zeros((rows, packer.int_size), dtype=torch.int32, device=device)
            self.floats = torch.zeros((rows, packer.float_size), dtype=torch.float32,
                                      device=device)
        else:
            self.batch = {k: torch.zeros_like(torch.as_tensor(v), device=device)
                          for k, v in example.items()}
        self.scalars = torch.zeros((rows, scalar_width), dtype=torch.int32, device=device)
        self.losses = torch.zeros((rows,), dtype=torch.float32, device=device)

    def batch_of(self, i: int) -> Dict[str, torch.Tensor]:
        if self.packer is None:
            return self.batch
        return self.packer.unpack(self.ints[i], self.floats[i])

    def load(self, i: int, item) -> None:
        """Copy one batch into row i on the current stream: a ``PackedBatch``
        from the prefetch ring, an ``(ints, floats)`` pair packed by this
        layout's packer, or (unpacked) a dict."""
        if isinstance(item, PackedBatch):
            item.copy_to(self.ints[i], self.floats[i])
        elif isinstance(item, tuple):
            ints, floats = item
            self.ints[i].copy_(ints, non_blocking=True)
            self.floats[i].copy_(floats, non_blocking=True)
        else:
            for key, value in item.items():
                self.batch[key].copy_(torch.as_tensor(value), non_blocking=True)


class _StepGraph:
    """A CUDA graph of ``n`` steps over static inputs (kept alive with it),
    and the kernel launches it makes at each replay
    (``ops/kernels/__init__.py``)."""

    def __init__(self, graph, tally: dict, inputs: _StepInputs):
        self.graph, self.tally, self.inputs = graph, tally, inputs

    def replay(self) -> None:
        self.graph.replay()
        add_tally(self.tally)


class _Layout:
    """One batch layout's steps: its packer (None for unpacked batches,
    which ``example`` shapes), its static inputs, its graphs by steps a
    call, and whether a step of it ran on the card (the warm-up)."""

    def __init__(self, packer: Optional[BatchPacker], example: Optional[Batch] = None):
        self.packer, self.example = packer, example
        self.inputs: Optional[_StepInputs] = None
        self.graphs: Dict[int, _StepGraph] = {}
        self.warm = False


def _announced(items: Iterator, on_begin: Callable[[int], None]) -> Iterator:
    """``items``, calling ``on_begin(b)`` as item b is handed out: a batch's
    begin hook runs once its batch has come from the prefetch ring and
    before its step."""
    for b, item in enumerate(items):
        on_begin(b)
        yield item


def request_signature(batch: Batch) -> tuple:
    """What keys a scorer's graph: each key's shape and dtype, in sorted key
    order (a labelled batch and an unlabelled one differ by the label)."""
    out = []
    for key in sorted(batch):
        value = batch[key]
        if isinstance(value, torch.Tensor):
            out.append((key, tuple(value.shape), str(value.dtype)))
        else:
            array = np.asarray(value)
            out.append((key, array.shape, str(array.dtype)))
    return tuple(out)


def _score_inputs(example: Batch, device: torch.device, packed: bool) -> StaticInputs:
    """Static device inputs of ``example``'s signature: the packed ``(ints,
    floats)`` pair of its ``BatchPacker`` (``inputs.batch``: the views the
    model reads), or one tensor a key."""
    if packed:
        packer = BatchPacker(example)
        buffers = (torch.zeros(packer.int_size, dtype=torch.int32, device=device),
                   torch.zeros(packer.float_size, dtype=torch.float32, device=device))
        inputs = StaticInputs(buffers, lambda batch, out: packer.pack(batch, out=out))
        inputs.batch = packer.unpack(*buffers)
        return inputs
    keys = sorted(example)
    buffers = [torch.zeros_like(torch.as_tensor(example[k]), device=device) for k in keys]

    def write(batch, out):
        for key, buffer in zip(keys, out):
            buffer.copy_(torch.as_tensor(batch[key]))

    inputs = StaticInputs(buffers, write)
    inputs.batch = dict(zip(keys, buffers))
    return inputs


def _uses_dropout(model: torch.nn.Module) -> bool:
    """Whether a module draws dropout masks when training (``Dense``,
    ``SASRecBlock``: a float ``dropout`` rate above 0)."""
    return any(isinstance(getattr(m, "dropout", None), float) and m.dropout > 0.0
               for m in model.modules())


def init_parameters(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from ``generator``: a module with its own
    ``init_parameters(generator)`` (the masked GRU's uniform, LayerNorm's
    ones and zeros, SVD++'s zero global bias, as flax initialises them)
    sets its own parameters first; every other parameter is normal(0, 0.01),
    in the model's parameter order."""
    owned = set()
    with torch.no_grad():
        for module in model.modules():
            init = getattr(module, "init_parameters", None)
            if init is not None:
                init(generator)
                owned.update(id(p) for p in module.parameters(recurse=False))
        for param in model.parameters():
            if id(param) not in owned:
                param.normal_(0.0, INIT_STD, generator=generator)


class Trainer:
    """Owns one model on one device (a mesh's rank), its optimizer and its
    step counter."""

    trains_quantized_tables = False

    def __init__(self, model: RecModel, device=None, packed_transfer: Optional[bool] = None,
                 mesh: Optional[Mesh] = None):
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh).__name__}")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's rank device {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # everything runs in full f32, as the JAX reference does: no TF32
            # in matmuls (PyTorch's default) nor in cuDNN (not its default)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device)
        # one device: the packed transfer is the default, as in the JAX trainer
        self.packed_transfer = mesh is None if packed_transfer is None else bool(packed_transfer)
        # the sharded leaves by flax path (this rank's rows), and each one's
        # whole shape and dtype (a tensor on the meta device)
        self._shards: Dict[str, RowShard] = {}
        self._full_shapes: Dict[str, torch.Tensor] = {}
        self.state: Optional[TrainState] = None
        self.best_params: Optional[Dict[str, torch.Tensor]] = None  # host copies, by flax path
        self.stop_training = False
        self.history: Optional[History] = None
        self.loss_fn: Optional[Callable] = None
        self._compiled = False
        # every loss of the last fit or fit_steps call, on the device
        self.step_losses: Optional[torch.Tensor] = None
        # the kept layouts by (packed, batch signature), least recently used first
        self._layouts: "OrderedDict[tuple, _Layout]" = OrderedDict()
        self._layout: Optional[_Layout] = None  # the layout of the last batch
        self._stream: Optional[torch.cuda.Stream] = None  # warm-up and capture
        self.metrics: Optional[MetricList] = None
        self.matmul_precision: Optional[str] = None
        self._scores = GraphCache(self.device)  # the scorer's graphs by request signature

    # ------------------------------------------------------------------
    # compile / init
    # ------------------------------------------------------------------

    def compile(self, optimizer: str = "adam", loss: Union[str, Callable] = "bce",
                metrics: Sequence[str] = ("ndcg@10", "hit@10"), lr: float = 1e-3,
                weight_decay: float = 0.0, user_sample_n: int = 100,
                grad_clip_norm: Optional[float] = None,
                matmul_precision: Optional[str] = None, **optimizer_kwargs) -> None:
        """Choose the dense optimizer (a name of ``optim.OPTIMIZERS``, with
        ``grad_clip_norm``'s global-norm clip before it and
        ``optimizer_kwargs`` such as ``b1``, ``b2`` and ``eps``), the loss (by
        name, or ``fn(prediction, target) -> scalar``), the metrics
        ``evaluate`` reports (``metric/metrics.py``; ``user_sample_n`` is the
        width of a candidate row) and the train step's matmul precision
        (None, ``"float32"`` or ``"highest"``: full f32; ``"bfloat16"``;
        anything else raises). A model whose prediction columns hold
        log-probabilities (``log_prob_task_columns``: ESMM's log pCTCVR)
        takes no sigmoid-based task slice on them (``logloss/<t>``,
        ``mse/<t>``): those raise here, as in the JAX trainer; ``auc/<t>``
        ranks them. The captured train steps are dropped, as the JAX
        trainer drops its traced step: the next step captures anew."""
        get_optimizer(optimizer)  # an unknown name raises here
        precision = check_precision(matmul_precision)
        metric_list = MetricList(list(metrics), user_sample_n=user_sample_n)
        log_prob_columns = getattr(self.model, "log_prob_task_columns", ())
        bad = [m.name for m in metric_list.metrics
               if isinstance(m, TaskSlice) and m.task in log_prob_columns
               and isinstance(m.inner, (LogLoss, MSE))]
        if bad:
            raise ValueError(f"{bad}: task column(s) {sorted(log_prob_columns)} of "
                             f"{type(self.model).__name__} are log-probabilities; only "
                             f"auc/<t> (rank-monotone) is meaningful there")
        self.optimizer_name, self.lr, self.weight_decay = optimizer, lr, weight_decay
        self.grad_clip_norm, self.optimizer_kwargs = grad_clip_norm, dict(optimizer_kwargs)
        self.loss_fn = get_loss(loss) if isinstance(loss, str) else loss
        self.metrics = metric_list
        self.matmul_precision = precision
        self._layouts.clear()
        self._layout = None
        self._compiled = True

    def _build_optimizer(self, named: Iterable[Tuple[str, torch.nn.Parameter]]
                         ) -> torch.optim.Optimizer:
        """The compiled dense optimizer over ``named`` (state-dict key,
        parameter) pairs; each key's flax path goes beside its parameter
        (adamw's decay mask)."""
        named = list(named)
        return build_optimizer(self.optimizer_name, [p for _, p in named], self.lr,
                               self.weight_decay, grad_clip_norm=self.grad_clip_norm,
                               paths=[flax_path(name) for name, _ in named],
                               sum_squares=self._sum_squares if self._shards else None,
                               **self.optimizer_kwargs)

    def _assert_compiled(self) -> None:
        if not self._compiled:
            raise RuntimeError("compile() must be called before training")

    def _assert_state(self) -> TrainState:
        self._assert_compiled()
        if self.state is None:
            raise RuntimeError("init_state() must be called before training")
        return self.state

    def _make_state(self, sample_batch: Batch, rng: torch.Generator) -> TrainState:
        self._shard_tables()
        return TrainState(optimizer=self._build_optimizer(self.model.named_parameters()),
                          rng=rng)

    def init_state(self, sample_batch: Batch, seed: int = 2020) -> TrainState:
        """Draw every parameter from ``torch.Generator(seed)``
        (``init_parameters``) and build the optimizer; the same generator then draws the dropout masks (and, for
        a quantized trainer, its table, which is a buffer). The step
        counter starts at 0. ``sample_batch`` names the tables a batch reads
        (the sparse trainer's protocol). Captured graphs are dropped."""
        self._assert_compiled()
        if self.model.has_quantized_table and not self.trains_quantized_tables:
            raise ValueError("a quantized table trains under QuantizedEmbeddingTrainer")
        self._layouts.clear()
        self._layout = None
        self._scores.clear()
        self._unshard()
        generator = torch.Generator(device=self.device).manual_seed(seed)
        init_parameters(self.model, generator)
        self.state = self._make_state(sample_batch, generator)
        return self.state

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _step(self, batch: Dict[str, torch.Tensor], scalars: torch.Tensor) -> torch.Tensor:
        """One step over a batch on the device and its row of step scalars
        (``state.py::StepScalars``); returns the loss (a device scalar).
        Capture-safe: no host sync, no copy from host memory and no host
        value that changes from step to step, so a CUDA graph replays it.
        The host's step count is the caller's to advance."""
        state = self.state
        prediction, target = self.model(batch, train=True, generator=state.rng)
        loss = self.loss_fn(prediction, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = self._average_over_data(loss)
        state.optimizer.step()
        return loss.detach()

    def _write_scalars(self, out: torch.Tensor, first_step: int) -> torch.Tensor:
        """Fill ``out [k, n]`` with the scalars of steps ``first_step`` on
        (1-based), computed on the host; on the card an asynchronous copy
        from pinned memory on the current stream."""
        rows = torch.from_numpy(self.state.scalars.host_rows(first_step, out.shape[0]))
        if out.device.type == "cuda":
            rows = rows.pin_memory()
        return out.copy_(rows, non_blocking=True)

    def train_step(self, batch: Batch) -> torch.Tensor:
        """One eager step of the loss's gradient over every parameter;
        returns the loss (a device scalar, not synchronised)."""
        state = self._assert_state()
        scalars = torch.empty((1, state.scalars.width), dtype=torch.int32, device=self.device)
        with precision_scope(self.matmul_precision):
            loss = self._step(self._to_device(self._local_batch(batch)),
                              self._write_scalars(scalars, state.step + 1)[0])
        state.step += 1
        return loss

    # ------------------------------------------------------------------
    # captured steps: packed batches, static buffers, CUDA graphs
    # ------------------------------------------------------------------

    @property
    def _graphs(self) -> Dict[int, _StepGraph]:
        """The graphs of the current layout, by steps a call."""
        return {} if self._layout is None else self._layout.graphs

    @property
    def _packer(self) -> Optional[BatchPacker]:
        """The packer of the current layout (None: unpacked batches)."""
        return None if self._layout is None else self._layout.packer

    def _adopt(self, key: tuple, make: Callable[[], _Layout]) -> _Layout:
        """Make the layout ``key`` current, keeping it if it is known, else
        ``make()``-ing it; a new one past ``MAX_LAYOUTS`` drops the least
        recently used one, its static inputs and its graphs."""
        layout = self._layouts.get(key)
        if layout is None:
            layout = self._layouts[key] = make()
            while len(self._layouts) > MAX_LAYOUTS:
                self._layouts.popitem(last=False)
        else:
            self._layouts.move_to_end(key)
        self._layout = layout
        return layout

    def batch_packer(self, example: Batch) -> BatchPacker:
        """The packer of ``example``'s layout, which ``fit_steps`` takes
        batches packed by (``pack(batch)``: an ``(ints, floats)`` pair, on
        the host or the device), and which becomes the current layout."""
        pin = self.device.type == "cuda"
        return self._adopt(("packed", batch_signature(example)),
                           lambda: _Layout(BatchPacker(example, pin_memory=pin))).packer

    def _inputs_for(self, item, rows: int) -> _StepInputs:
        """The static inputs of ``item``'s layout, at least ``rows`` deep
        (deeper inputs drop the layout's graphs over the old ones)."""
        if isinstance(item, PackedBatch):
            layout = self._adopt(("packed", item.packer.signature), lambda: _Layout(item.packer))
        elif isinstance(item, tuple):
            layout = self._layout
            if self.mesh is not None:
                raise ValueError("a mesh splits dict batches: pass dicts, not packed pairs")
            if layout is None or layout.packer is None:
                raise ValueError("a packed batch needs its layout's packer: pass a dict batch "
                                 "first, or pack with trainer.batch_packer(example)")
        else:  # unpacked
            layout = self._adopt(("unpacked", batch_signature(item)),
                                 lambda: _Layout(None, item))
        if layout.inputs is None or layout.inputs.rows < rows:
            layout.inputs = _StepInputs(rows, self.device, self.state.scalars.width,
                                        layout.packer, layout.example)
            layout.graphs.clear()
        return layout.inputs

    def _steps(self, inputs: _StepInputs, n: int) -> None:
        """The body of a call: steps 0..n-1 over the inputs' rows, each loss
        into its slot, at the compiled matmul precision. A graph captures
        exactly this."""
        with precision_scope(self.matmul_precision):
            for i in range(n):
                inputs.losses[i].copy_(self._step(inputs.batch_of(i), inputs.scalars[i]))

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _warm_up(self, inputs: _StepInputs, n: int) -> None:
        """A layout's first step (``_call`` runs one) on the card, eagerly,
        on the stream the captures use."""
        stream = self._side_stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._steps(inputs, n)
        torch.cuda.current_stream().wait_stream(stream)
        self._layout.warm = True

    def _capture(self, inputs: _StepInputs, n: int) -> _StepGraph:
        """Capture n steps over the inputs. The dropout generator is
        registered with the graph, so each replay draws new masks, as the
        eager steps would; without that, a model with dropout raises. A
        capture that fails raises, and PyTorch then leaves the generators it
        registered (its default CUDA generator among them) in capture mode:
        the process cannot draw from them again. Python's collector is paused
        meanwhile (``collector_paused``)."""
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        if register is not None:
            register(self.state.rng)
        elif _uses_dropout(self.model):
            raise RuntimeError("this torch cannot register the dropout generator with a CUDA "
                               "graph: fit_steps on the card takes no dropout here")
        with collector_paused(), capture_tally() as tally:
            with torch.cuda.graph(graph, stream=self._side_stream(),
                                  capture_error_mode="thread_local"):
                self._steps(inputs, n)
        return _StepGraph(graph, dict(tally), inputs)

    def _captures(self) -> bool:
        """Whether steps run as CUDA graphs: on the card, unless autograd's
        anomaly mode is on (``utils/profiling.py::enable_nan_debugging``),
        whose checks read values back to the host and cannot be captured;
        then every step runs eagerly."""
        return self.device.type == "cuda" and not torch.is_anomaly_enabled()

    def _run(self, inputs: _StepInputs, n: int) -> None:
        """n steps over the loaded rows of the current layout: on the card
        the replay of their graph (captured at first use), on the CPU (or
        under anomaly mode) the same body eagerly."""
        state, layout = self.state, self._layout
        self._write_scalars(inputs.scalars[:n], state.step + 1)
        if not self._captures():
            self._steps(inputs, n)
        elif not layout.warm:
            self._warm_up(inputs, n)
        else:
            graph = layout.graphs.get(n)
            if graph is None:
                graph = layout.graphs[n] = self._capture(inputs, n)
            graph.replay()
        state.step += n

    def _call(self, items: Iterator, k: int, losses: torch.Tensor) -> int:
        """Up to k steps over the next batches, as one call: their losses go
        to ``losses[:n]``; returns n (0 when the batches are spent). On the
        card a new layout's first step runs alone first (the warm-up), the
        graph of k steps is captured at once after it (a capture runs
        nothing: the layout's next call of k steps replays it), and the rest
        of the call runs after them. Each batch is copied in as it comes,
        which frees its prefetch slot."""
        first = next(items, None)
        if first is None:
            return 0
        inputs = self._inputs_for(first, k)
        layout = self._layout
        done, pending = 0, [first]
        if self._captures() and not layout.warm:
            inputs.load(0, first)
            self._run(inputs, 1)
            losses[0].copy_(inputs.losses[0])
            if k not in layout.graphs:
                layout.graphs[k] = self._capture(inputs, k)
            done, pending = 1, []
        n = 0
        for item in chain(pending, islice(items, k - done - len(pending))):
            if self._inputs_for(item, k) is not inputs:
                raise ValueError("the batches of one call must share one layout")
            inputs.load(n, item)
            n += 1
        if n:
            self._run(inputs, n)
            losses[done:done + n].copy_(inputs.losses[:n])
        return done + n

    def _feed(self, batches: Iterable) -> Iterator:
        """The items ``_call`` takes: with the packed transfer, the batches
        packed on the prefetch thread (a ring to close when done), else the
        batches themselves; on a mesh each batch's rows of this data index."""
        if self.mesh is not None:
            batches = map(self._local_batch, batches)
        if self.packed_transfer:
            return device_put_prefetch(iter(batches), PREFETCH,
                                       pin_memory=self.device.type == "cuda")
        return iter(batches)

    # ------------------------------------------------------------------
    # fit (the JAX trainer's fit) and fit_steps
    # ------------------------------------------------------------------

    def fit(self, reader, batch_size: int, epochs: int, train_mode: Optional[TrainMode] = None,
            verbose: int = 1, callbacks: Optional[Union[List[Callback], CallbackList]] = None,
            shuffle: bool = True, drop_last: bool = True, dev_batch_size: Optional[int] = None,
            dev_freq: int = 1, seed: int = 2020, eval_dev: bool = True) -> History:
        """``epochs`` epochs over the train split of ``reader`` (any object
        with ``get_train_dataset_size()``, ``get_dataset_size(split)``,
        ``get_batch(split, indices)`` and ``train_mode``; under
        ``TrainMode.PAIR_WISE`` also ``train_neg_sample()``, called at each
        epoch's start), shuffled by ``default_rng(seed)``, each step through
        the captured step (one a call: ``_call``); every ``dev_freq`` epochs
        the compiled metrics over the dev split (``evaluate``, the captured
        scorer). The epoch logs are the last batch's ``loss`` and the dev
        metrics, as the JAX trainer keeps them. Only when a callback has
        train-batch hooks is each step's loss copied to the host (for
        ``on_train_batch_end``); else an epoch runs without a host sync until
        its end. A callback ends the run by setting ``stop_training``.
        Without a state, the first 2 train rows initialise it.
        ``step_losses`` holds every step's loss, on the device."""
        self._assert_compiled()
        if self.state is None:
            bootstrap = reader.get_batch("train",
                                         np.arange(min(2, reader.get_train_dataset_size())))
            self.init_state(bootstrap, seed=seed)
        train_mode = train_mode or reader.train_mode
        batches = num_train_batches(reader.get_train_dataset_size(), batch_size, drop_last)
        if not isinstance(callbacks, CallbackList):
            callbacks = CallbackList(callbacks, add_history=True, add_progbar=verbose != 0,
                                     trainer=self, verbose=verbose, epochs=epochs,
                                     batches=batches)
        self.history = callbacks.history
        shuffle_rng = np.random.default_rng(seed)
        epoch_losses: List[torch.Tensor] = []
        self.stop_training = False
        callbacks.on_train_begin()
        for epoch in range(epochs):
            callbacks.on_epoch_begin(epoch)
            if train_mode == TrainMode.PAIR_WISE:
                reader.train_neg_sample()
            losses = torch.zeros((batches,), dtype=torch.float32, device=self.device)
            n = self._fit_epoch(train_batches(reader, batch_size, shuffle_rng, shuffle, drop_last),
                                losses, callbacks)
            epoch_losses.append(losses[:n])
            epoch_logs = {"loss": float(losses[n - 1])} if n else {}
            if eval_dev and (epoch + 1) % dev_freq == 0 and not self.stop_training:
                epoch_logs.update(self.evaluate(reader, split="dev",
                                                batch_size=dev_batch_size or batch_size,
                                                verbose=verbose, callbacks=callbacks))
            callbacks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        callbacks.on_train_end()
        self.step_losses = torch.cat(epoch_losses) if epoch_losses else None
        return self.history

    def _fit_epoch(self, batches: Iterator[Batch], losses: torch.Tensor,
                   callbacks: CallbackList) -> int:
        """One epoch's steps, one a call, each loss into its slot of
        ``losses``; with train-batch hooks, the hooks around each step (its
        loss copied to the host) and a stop after the batch that sets
        ``stop_training``. Returns the steps taken."""
        hooks = callbacks.implements_train_batch_hooks()
        items = self._feed(batches)
        feed = _announced(items, callbacks.on_train_batch_begin) if hooks else items
        done = 0
        try:
            while self._call(feed, 1, losses[done:]):
                done += 1
                if hooks:
                    callbacks.on_train_batch_end(done - 1, {"loss": float(losses[done - 1])})
                    if self.stop_training:
                        break
        finally:
            if self.packed_transfer:
                items.close()
        return done

    def fit_steps(self, batches: Iterable[Batch], steps: int, log_every: int = 100,
                  callbacks: Optional[Union[List[Callback], CallbackList]] = None,
                  steps_per_call: int = 1, seed: int = 2020, verbose: int = 0) -> History:
        """``steps`` train steps over ``batches`` (dicts, or ``(ints,
        floats)`` pairs packed by ``batch_packer``), ``steps_per_call`` of
        them a call: on the card one replay of a captured graph, on the CPU
        the same steps eagerly. Each ``log_every`` window is an "epoch" of
        the callbacks: ``history["loss"]`` holds the loss after the call
        that ends each window (and after a shorter last one), as in the JAX
        trainer; ``step_losses`` every step's loss, on the device. With one
        step a call, the train-batch hooks run around each step (its loss
        copied to the host) and ``stop_training`` ends the run after it;
        with more, only the windows' ends are logged, as the JAX trainer's
        fused steps do. ``steps_per_call > 1`` needs the packed transfer.
        ``verbose`` adds a progress bar (the JAX default is 1; here 0, so
        no callback syncs a step unless asked). Without a state, the first
        batch initialises it."""
        self._assert_compiled()
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be at least 1, got {steps_per_call}")
        if steps_per_call > 1 and not self.packed_transfer:
            raise ValueError("steps_per_call > 1 requires packed_transfer")
        iterator = iter(batches)
        if self.state is None:
            first = next(iterator)
            self.init_state(first, seed=seed)
            iterator = chain([first], iterator)
        if not isinstance(callbacks, CallbackList):
            callbacks = CallbackList(callbacks, add_history=True, add_progbar=verbose != 0,
                                     trainer=self, verbose=verbose,
                                     epochs=-(-steps // log_every), batches=log_every)
        self.history = callbacks.history
        hooks = steps_per_call == 1 and callbacks.implements_train_batch_hooks()
        losses = torch.zeros((max(steps, 0),), dtype=torch.float32, device=self.device)
        window = since_log = done = 0
        items = self._feed(iterator)
        feed = _announced(items, callbacks.on_train_batch_begin) if hooks else items
        self.stop_training = False
        callbacks.on_train_begin()
        callbacks.on_epoch_begin(window)
        try:
            while done < steps and not self.stop_training:
                n = self._call(feed, min(steps_per_call, steps - done), losses[done:])
                if n == 0:
                    break
                done += n
                since_log += n
                if hooks:
                    callbacks.on_train_batch_end(done - 1, {"loss": float(losses[done - 1])})
                if since_log >= log_every:
                    callbacks.on_epoch_end(window, {"loss": float(losses[done - 1])})
                    since_log = 0
                    window += 1
                    if done < steps:
                        callbacks.on_epoch_begin(window)
        finally:
            if self.packed_transfer:
                items.close()
        if done and since_log:
            callbacks.on_epoch_end(window, {"loss": float(losses[done - 1])})
        callbacks.on_train_end()
        self.step_losses = losses[:done]
        return self.history

    # ------------------------------------------------------------------
    # scoring: one CUDA graph a request signature
    # ------------------------------------------------------------------

    def _with_table_rows(self, batch: Batch) -> Batch:
        """``batch`` with the rows of each table the model cannot gather
        itself injected: none here (the sparse trainer's bf16 and byte
        rows, a mesh's sharded quantized tables)."""
        return batch

    def _score_body(self, inputs: StaticInputs) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.model(self._with_table_rows(inputs.batch), train=False)

    def _eval_step(self, batch: Batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(prediction, target)`` of one batch on the device (target None
        without a label), fresh tensors: on the card the replay of the
        batch signature's graph (see the module docstring), on the CPU the
        same body eagerly over the same static inputs. On a mesh each data
        index scores its rows, and the scores are gathered."""
        local = self._local_batch(batch)
        packed = self.packed_transfer
        prediction, target = self._scores.run(
            request_signature(local), lambda inputs: inputs.load(local, local.values()),
            lambda: _score_inputs(local, self.device, packed), self._score_body)
        return self._gathered(prediction), None if target is None else self._gathered(target)

    def _score_eager(self, batch: Batch) -> torch.Tensor:
        with torch.inference_mode():
            local = self._to_device(self._local_batch(batch))
            prediction, _ = self.model(self._with_table_rows(local), train=False)
        return self._gathered(prediction)

    def make_serving_fn(self) -> Callable[[Batch], torch.Tensor]:
        """Scorer over the model's current parameters: moves the batch to the
        device and returns the prediction there (``[B]``, or ``[B, N]`` for
        candidate rows), a fresh tensor. It needs no label column. On the
        card a request signature's second request captures a CUDA graph and
        every later one replays it; ``serve.eager(batch)`` runs the same
        model call eagerly."""

        def serve(batch: Batch) -> torch.Tensor:
            return self._eval_step(batch)[0]

        serve.eager = self._score_eager
        return serve

    # ------------------------------------------------------------------
    # export: torch.export of the eager scorer
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _serving_model(self) -> Iterator[RecModel]:
        """The model as an exported scorer reads it: here, as it is."""
        yield self.model

    def export_program(self, sample_batch: Batch
                       ) -> Tuple["torch.export.ExportedProgram", List[str]]:
        """``(program, keys)``: the eager scorer over the current parameters,
        exported with ``sample_batch``'s shapes, and the batch keys it takes
        in order (see the module docstring). Not on a mesh: export what a
        one-process trainer loads from its saved weights."""
        self._assert_state()
        if self.mesh is not None:
            raise ValueError("a mesh trainer's tables are sharded: load its saved weights into a "
                             "one-process trainer and export there")
        batch = self._to_device(sample_batch)
        keys = sorted(batch)
        with self._serving_model() as model, torch.no_grad():
            program = _export_scorer(model, batch, keys)
            kept = _kept_keys(program, keys)
            if kept != keys:
                program = _export_scorer(model, batch, kept)
        return program, kept

    def export_serving(self, filepath: str, sample_batch: Batch) -> None:
        """Export the scorer (``export_program``) to ``filepath``: a program
        with the parameters baked in, loadable without the model code
        (``load_serving``). Shapes are fixed to the sample batch's."""
        program, keys = self.export_program(sample_batch)
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        meta = json.dumps({"keys": keys, "device": str(self.device)})
        torch.export.save(program, filepath, extra_files={SERVING_META: meta})

    @staticmethod
    def load_serving(filepath: str) -> Callable[[Batch], torch.Tensor]:
        """Load an ``export_serving`` file -> ``serve(batch) -> scores`` on the
        device it was exported on (``serve.keys``: the batch keys it reads)."""
        from pytorchrec_tpu_torch.ops.kernels import cross, din_attention, fm  # noqa: F401 (ops)

        extra = {SERVING_META: ""}
        program = torch.export.load(filepath, extra_files=extra)
        meta = json.loads(extra[SERVING_META])
        module, keys, device = program.module(), meta["keys"], torch.device(meta["device"])

        def serve(batch: Batch) -> torch.Tensor:
            with torch.no_grad():
                return module(*(torch.as_tensor(batch[k]).to(device) for k in keys))

        serve.keys = keys
        return serve

    # ------------------------------------------------------------------
    # evaluate / predict
    # ------------------------------------------------------------------

    def _callbacks(self, callbacks, reader, split: str, batch_size: int,
                   verbose: int) -> CallbackList:
        if isinstance(callbacks, CallbackList):
            return callbacks
        size = reader.get_dataset_size(split)
        return CallbackList(callbacks, add_progbar=verbose != 0, trainer=self, verbose=verbose,
                            epochs=1, batches=-(-size // batch_size))

    def _collect_predictions(self, reader, split: str, batch_size: int, callbacks: CallbackList,
                             hooks: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Score a split; ``(predictions, targets)`` on the host. The device
        parts, cut to each batch's valid rows, are concatenated there and
        copied to the host once."""
        preds: List[torch.Tensor] = []
        targets: List[torch.Tensor] = []
        on_begin = getattr(callbacks, f"on_{hooks}_batch_begin")
        on_end = getattr(callbacks, f"on_{hooks}_batch_end")
        for b, (batch, valid) in enumerate(eval_batches(reader, split, batch_size)):
            on_begin(b)
            prediction, target = self._eval_step(batch)
            preds.append(prediction[:valid])
            if target is not None:
                targets.append(target[:valid])
            on_end(b)
        predictions = torch.cat(preds).cpu().numpy()
        return predictions, torch.cat(targets).cpu().numpy() if targets else None

    def _collect_metric_partials(self, reader, split: str, batch_size: int,
                                 callbacks: CallbackList) -> Dict[str, float]:
        """Streaming evaluation: each batch folds into a fixed-size metric
        accumulator on the device (``MetricList.partial_update``), so memory
        does not grow with the split; one small host copy at the end."""
        state = self.metrics.partial_init(self.device)
        for b, (batch, valid) in enumerate(eval_batches(reader, split, batch_size)):
            callbacks.on_test_batch_begin(b)
            prediction, target = self._eval_step(batch)
            state = self.metrics.partial_update(state, prediction, target, valid)
            callbacks.on_test_batch_end(b)
        return self.metrics.partial_finalize(state)

    def evaluate(self, reader, split: str = "test", batch_size: int = 256, verbose: int = 1,
                 callbacks: Optional[Union[List[Callback], CallbackList]] = None,
                 streaming: bool = False) -> Dict[str, float]:
        """The compiled metrics over ``split`` of ``reader`` (any object with
        ``get_dataset_size(split)`` and ``get_batch(split, indices)``), in
        fixed-shape batches whose last one is padded and cut
        (``data/loader.py``). ``streaming=True`` accumulates metric partials
        on the device: exact for the rank metrics, logloss and MSE, AUC
        binned to about 1e-4."""
        self._assert_compiled()
        callbacks = self._callbacks(callbacks, reader, split, batch_size, verbose)
        callbacks.on_test_begin()
        if streaming:
            logs = self._collect_metric_partials(reader, split, batch_size, callbacks)
        else:
            predictions, targets = self._collect_predictions(reader, split, batch_size,
                                                             callbacks, "test")
            logs = self.metrics(predictions, targets)
        callbacks.on_test_end(logs)
        return logs

    def predict(self, reader, split: str = "test", batch_size: int = 256, verbose: int = 0,
                callbacks: Optional[Union[List[Callback], CallbackList]] = None) -> np.ndarray:
        """The predictions over ``split`` of ``reader``, on the host."""
        self._assert_compiled()
        callbacks = self._callbacks(callbacks, reader, split, batch_size, verbose)
        callbacks.on_predict_begin()
        predictions, _ = self._collect_predictions(reader, split, batch_size, callbacks,
                                                   "predict")
        callbacks.on_predict_end()
        return predictions

    # ------------------------------------------------------------------
    # weights and checkpoints, restored in place
    # ------------------------------------------------------------------

    def save_weights(self, filepath: str) -> None:
        """The weights (``leaves_of``: host copies by flax path) to
        ``filepath``, written whole or not at all (``atomic_save``); on a
        mesh by rank 0, every rank waiting for it."""
        self._assert_state()
        leaves = leaves_of(self)
        if self.writes_files:
            atomic_save(leaves, filepath)
        self._barrier()

    def load_weights(self, filepath: str) -> None:
        """Copy the weights in ``filepath`` into the trainer's tensors, in
        place; the step, the optimizer's state and the generator stay."""
        self._assert_state()
        load_leaves(torch.load(filepath, map_location="cpu", weights_only=True), self)

    def save_best_weights(self) -> None:
        """Keep a host copy of the weights as ``best_params``."""
        self._assert_state()
        self.best_params = leaves_of(self)

    def load_best_weights(self) -> None:
        """Copy ``best_params`` back into the trainer's tensors, in place."""
        if self.best_params is None:
            raise RuntimeError("no best weights are kept: save_best_weights() first")
        load_leaves(self.best_params, self)

    def _dense_paths(self) -> Dict[torch.Tensor, str]:
        """Each parameter of the dense optimizer, with its flax path."""
        by_id = {id(p): flax_path(name) for name, p in self.model.named_parameters()}
        return {p: by_id[id(p)] for group in self.state.optimizer.param_groups
                for p in group["params"]}

    def checkpoint_state(self) -> Dict[str, Any]:
        """Host copies of the whole train state: ``params`` (the weights),
        ``opt_state`` (the dense optimizer's state by its parameter's flax
        path, for each parameter that has one), ``step``, ``rng_state`` (the
        dropout generator's) and what the trainer's kind adds
        (``_extra_checkpoint``)."""
        state = self._assert_state()
        opt_state = {}
        for param, path in self._dense_paths().items():
            entry = state.optimizer.state.get(param)
            if entry:
                opt_state[path] = {k: self._full_rows(path, v) if v.dim() else
                                   v.detach().to("cpu", copy=True) for k, v in entry.items()}
        return {"params": leaves_of(self), "opt_state": opt_state, "step": int(state.step),
                "rng_state": state.rng.get_state(), **self._extra_checkpoint()}

    def load_checkpoint_state(self, payload: Dict[str, Any]) -> None:
        """Restore ``checkpoint_state``'s dict into the trainer's tensors, in
        place. A parameter whose optimizer state is absent from the payload
        gets its state zeroed (a state that never stepped); one that has no
        state yet here gets new tensors (no graph can have captured them:
        a step makes them, and the warm-up step precedes every capture)."""
        state = self._assert_state()
        paths = self._dense_paths()
        saved = payload["opt_state"]
        unknown = sorted(set(saved) - set(paths.values()))
        if unknown:
            raise KeyError(f"optimizer state for {unknown}, which the optimizer lacks")
        load_leaves(payload["params"], self)
        with torch.no_grad():
            for param, path in paths.items():
                entry, values = state.optimizer.state.get(param), saved.get(path)
                if values is not None:
                    values = {k: self._local_rows(path, v) if v.dim() else v
                              for k, v in values.items()}
                if entry:
                    for key, tensor in entry.items():
                        if values is None:
                            tensor.zero_()
                        else:
                            tensor.copy_(values[key])
                elif values:
                    state.optimizer.state[param] = {k: v.to(param.device)
                                                    for k, v in values.items()}
        state.step = int(payload["step"])
        state.rng.set_state(payload["rng_state"])
        self._load_extra_checkpoint(payload)

    def _extra_checkpoint(self) -> Dict[str, Any]:
        """What a checkpoint holds beyond the weights, the dense optimizer,
        the step and the generator (none here)."""
        return {}

    def _load_extra_checkpoint(self, payload: Dict[str, Any]) -> None:
        """Restore ``_extra_checkpoint``'s entries in place."""

    def save_checkpoint(self, filepath: str) -> None:
        """The whole train state (``checkpoint_state``) to ``filepath``,
        written whole or not at all; on a mesh by rank 0, every rank waiting
        for it."""
        payload = self.checkpoint_state()
        if self.writes_files:
            atomic_save(payload, filepath)
        self._barrier()

    def restore_checkpoint(self, filepath: str) -> None:
        """Restore ``save_checkpoint``'s file into this trainer's state, in
        place (``init_state`` first: its tensors receive the values)."""
        if self.state is None:
            raise RuntimeError("init_state() first: a checkpoint restores into the state's "
                               "tensors")
        self.load_checkpoint_state(torch.load(filepath, map_location="cpu", weights_only=True))

    # ------------------------------------------------------------------
    # the mesh: sharded tables, the batch's rows, the collectives
    # ------------------------------------------------------------------

    @property
    def writes_files(self) -> bool:
        """Whether this process writes what a save makes: the one process,
        or rank 0 of a mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def _local_batch(self, batch: Batch) -> Batch:
        """On a mesh, this data index's rows of a global batch."""
        if self.mesh is None:
            return batch
        if not isinstance(batch, dict):
            raise ValueError("a mesh splits dict batches: pass dicts, not packed pairs")
        return data_sharding(self.mesh).local(batch)

    def _gathered(self, scores: torch.Tensor) -> torch.Tensor:
        """On a mesh, the data group's scores in batch order."""
        return scores if self.mesh is None else self.mesh.all_gather(scores, DATA_AXIS)

    def _set_leaf(self, path: str, value: torch.Tensor) -> None:
        """Put ``value`` in the model where flax path ``path`` lives: a
        buffer, or a parameter."""
        module_name, _, name = _port_key(path)[0].rpartition(".")
        module = self.model.get_submodule(module_name)
        if name in module._buffers:
            module.register_buffer(name, value)
        else:
            setattr(module, name, torch.nn.Parameter(value))

    def _record_shard(self, path: str, shard: RowShard, full: torch.Tensor) -> torch.Tensor:
        """Note that ``path`` holds this rank's rows of ``full``; returns
        them (a copy)."""
        self._shards[path] = shard
        self._full_shapes[path] = torch.empty_like(full, device="meta")
        return shard.local(full.detach()).clone()

    def _shard_tables(self, skip: Iterable[str] = ()) -> None:
        """On a mesh, each ``Embedding`` table the rule shards
        (``param_shardings``; the tables in ``skip`` aside) keeps this
        rank's rows, and its module looks up through the model group."""
        if self.mesh is None:
            return
        skip = set(skip)
        params = {flax_path(k): p for k, p in self.model.named_parameters()}
        specs = param_shardings({k: p for k, p in params.items() if k not in skip}, self.mesh)
        for path, spec in specs.items():
            if not isinstance(spec, RowShard):
                continue
            module_name, _, name = _port_key(path)[0].rpartition(".")
            module = self.model.get_submodule(module_name)
            if not isinstance(module, Embedding) or name != "embedding":
                raise ValueError(f"{path} is sharded but is not an Embedding's table")
            self._set_leaf(path, self._record_shard(path, spec, params[path]))
            module.mesh = self.mesh

    def _unshard(self) -> None:
        """Give every sharded leaf back its whole shape (its values to be
        drawn anew) and its module the plain lookup."""
        for path, whole in self._full_shapes.items():
            module = self.model.get_submodule(_port_key(path)[0].rpartition(".")[0])
            if isinstance(module, Embedding):
                module.mesh = None
            self._set_leaf(path, torch.empty_like(whole, device=self.device))
        self._shards, self._full_shapes = {}, {}

    def _sum_squares(self, params: List[torch.Tensor]) -> torch.Tensor:
        """The global norm's sum of squares on a mesh: the replicated
        gradients' squares, plus the table shards' summed over the model
        group."""
        sharded = {id(p) for name, p in self.model.named_parameters()
                   if flax_path(name) in self._shards}
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        own = sum((torch.sum(p.grad * p.grad) for p in params if id(p) not in sharded), zero)
        shards = sum((torch.sum(p.grad * p.grad) for p in params if id(p) in sharded), zero)
        return own + self.mesh.psum(shards.clone(), MODEL_AXIS)

    def _average_over_data(self, loss: torch.Tensor) -> torch.Tensor:
        """On a mesh, every dense gradient and the loss averaged over the
        data group, in one ``all_reduce``; returns the averaged loss."""
        if self.mesh is None:
            return loss
        params = [p for group in self.state.optimizer.param_groups for p in group["params"]
                  if p.grad is not None]
        flat = torch.cat([loss.detach().reshape(1)] + [p.grad.reshape(-1) for p in params])
        self.mesh.psum(flat, DATA_AXIS)
        flat /= self.mesh.data
        at = 1
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[at:at + n].view_as(p.grad))
            at += n
        return flat[0]

    def _table_rows(self, shard: Optional[RowShard], ids: torch.Tensor,
                    gather: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """On a mesh, a table's f32 rows at the global ``ids`` for the
        trainer to inject (no gradient flows into the table): ``gather(rows)``
        of a whole table, or of a shard its owned rows, zeros elsewhere,
        summed over the model group (``masked_psum_lookup``'s forward)."""
        if shard is None:
            return gather(ids)
        local, owned = owned_ids(ids, shard.offset, shard.rows_per_shard)
        values = gather(local.clamp(max=shard.rows_per_shard - 1))
        return self.mesh.psum(torch.where(owned[:, None], values, 0.0), MODEL_AXIS)

    def _update_inputs(self, shard: Optional[RowShard], ids: torch.Tensor, grads: torch.Tensor,
                       packed: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """On a mesh, a table update's ``(ids, rows, grads)`` for this rank:
        the global batch's ids and row grads (scaled by ``1/d``: each comes
        from a rank's mean loss over ``B/d`` rows), gathered over the data
        group in batch order, so the update's stable sort orders them as one
        process would; a shard's ids as its rows, those of other shards one
        past its last row, which every update drops; and the ``packed``
        rows at them before the update (None: an unpacked table)."""
        mesh = self.mesh
        ids = mesh.all_gather(ids, DATA_AXIS)
        grads = mesh.all_gather(grads * (1.0 / mesh.data), DATA_AXIS)
        if shard is not None:
            ids, _ = owned_ids(ids, shard.offset, shard.rows_per_shard)
        rows = None if packed is None else packed.index_select(
            0, ids.clamp(max=packed.shape[0] - 1))
        return ids, rows, grads

    def _full_rows(self, path: str, tensor: torch.Tensor) -> torch.Tensor:
        """A host copy of ``tensor``, whole: gathered over its shard's axis
        (the model group) where it holds this rank's rows of the sharded
        leaf ``path``."""
        shard = self._shards.get(path)
        if shard is not None:
            tensor = self.mesh.all_gather(tensor.detach().to(self.device), shard.axis)
        return tensor.detach().to("cpu", memory_format=torch.contiguous_format, copy=True)

    def _local_rows(self, path: str, value):
        """This rank's rows of a whole leaf ``path`` (or the leaf where it
        is not sharded)."""
        shard = self._shards.get(path)
        return value if shard is None else shard.local(value)

    def _held_leaves(self) -> Dict[str, torch.Tensor]:
        """Leaves (flax path -> tensor) the trainer holds outside the model,
        which ``leaves_of`` gives and ``load_leaves`` loads: none here."""
        return {}

    def _full_leaves(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``leaves_of``'s host copies with every sharded leaf whole."""
        if not self._shards:
            return leaves
        return {path: self._full_rows(path, value) for path, value in leaves.items()}

    def _local_leaves(self, flat: Mapping[str, Any]) -> Mapping[str, Any]:
        """Whole leaves (``load_leaves``'s) cut to this rank's rows."""
        if not self._shards:
            return flat
        return {path: self._local_rows(path, value) for path, value in flat.items()}
