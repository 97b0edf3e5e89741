"""Trainer (port of ``pytorchrec_tpu/training/trainer.py``): compile,
init_state, train_step, fit_steps and serving.

``Trainer(model, device=None)`` places the model on the card (or on the CPU
when asked). ``compile(optimizer, loss, lr, weight_decay)`` picks the dense
optimizer and the loss; ``init_state(sample_batch, seed)`` draws every
parameter from a ``torch.Generator`` seeded with ``seed`` (normal(0, 0.01),
the framework's init) and builds the optimizer; ``train_step(batch)`` runs
one forward, backward and optimizer step and returns the loss;
``fit_steps(batches, steps, log_every)`` runs ``steps`` of them and logs the
loss at the end of each ``log_every`` window. ``make_serving_fn()`` returns
the scorer ``fn(batch) -> prediction``.

Batches are dicts of numpy arrays or tensors; each step moves them to the
device (a no-op for tensors already there). Metrics, evaluation, callbacks
and the host input pipeline come with the fit loop (A7) and raise until
then. The JAX trainer jits one pure step over a donated state; the port runs
eagerly and updates the model's parameters in place.
"""

from __future__ import annotations

from itertools import chain
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Union

import torch

from pytorchrec_tpu_torch.loss import get_loss
from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.ops.embedding import INIT_STD
from pytorchrec_tpu_torch.optim import OPTIMIZERS, build_optimizer
from pytorchrec_tpu_torch.training.callbacks import History
from pytorchrec_tpu_torch.training.state import TrainState
from pytorchrec_tpu_torch.utils.device import resolve_device

Batch = Dict[str, Any]


class Trainer:
    """Owns one model on one device, its optimizer and its step counter."""

    trains_quantized_tables = False

    def __init__(self, model: RecModel, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # everything runs in full f32, as the JAX reference does: no TF32
            # in matmuls (PyTorch's default) nor in cuDNN (not its default)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device)
        self.state: Optional[TrainState] = None
        self.history: Optional[History] = None
        self.loss_fn: Optional[Callable] = None
        self._compiled = False

    # ------------------------------------------------------------------
    # compile / init
    # ------------------------------------------------------------------

    def compile(self, optimizer: str = "adam", loss: Union[str, Callable] = "bce",
                metrics: Sequence[str] = (), lr: float = 1e-3,
                weight_decay: float = 0.0) -> None:
        """Choose the dense optimizer (by name) and the loss (by name, or
        ``fn(prediction, target) -> scalar``)."""
        if tuple(metrics):
            raise NotImplementedError("metrics come with the evaluation loop, not ported yet; "
                                      "pass metrics=()")
        if optimizer not in OPTIMIZERS:
            raise NotImplementedError(f"optimizer {optimizer!r} is not ported yet; ported: "
                                      f"{sorted(OPTIMIZERS)}")
        self.optimizer_name, self.lr, self.weight_decay = optimizer, lr, weight_decay
        self.loss_fn = get_loss(loss) if isinstance(loss, str) else loss
        self._compiled = True

    def _assert_compiled(self) -> None:
        if not self._compiled:
            raise RuntimeError("compile() must be called before training")

    def _assert_state(self) -> TrainState:
        self._assert_compiled()
        if self.state is None:
            raise RuntimeError("init_state() must be called before training")
        return self.state

    def _make_state(self, sample_batch: Batch, rng: torch.Generator) -> TrainState:
        return TrainState(optimizer=build_optimizer(
            self.optimizer_name, self.model.parameters(), self.lr, self.weight_decay), rng=rng)

    def init_state(self, sample_batch: Batch, seed: int = 2020) -> TrainState:
        """Draw every parameter from ``torch.Generator(seed)`` and build the
        optimizer; the same generator then draws the dropout masks (and, for
        a quantized trainer, its table, which is a buffer). The step
        counter starts at 0. ``sample_batch`` names the tables a batch reads
        (the sparse trainer's protocol)."""
        self._assert_compiled()
        if self.model.has_quantized_table and not self.trains_quantized_tables:
            raise ValueError("a quantized table trains under QuantizedEmbeddingTrainer")
        generator = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            for param in self.model.parameters():
                param.normal_(0.0, INIT_STD, generator=generator)
        self.state = self._make_state(sample_batch, generator)
        return self.state

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def train_step(self, batch: Batch) -> torch.Tensor:
        """One step of the loss's gradient over every parameter; returns the
        loss (a device scalar, not synchronised)."""
        state = self._assert_state()
        prediction, target = self.model(self._to_device(batch), train=True, generator=state.rng)
        loss = self.loss_fn(prediction, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    def fit_steps(self, batches: Iterable[Batch], steps: int, log_every: int = 100,
                  callbacks=None, seed: int = 2020) -> History:
        """``steps`` train steps over ``batches``; ``history["loss"]`` holds
        the loss at the end of each ``log_every`` window (and of a shorter
        last one). Without a state, the first batch initialises it."""
        self._assert_compiled()
        if callbacks is not None:
            raise NotImplementedError("callbacks come with the fit loop, not ported yet")
        iterator = iter(batches)
        if self.state is None:
            first = next(iterator)
            self.init_state(first, seed=seed)
            iterator = chain([first], iterator)
        history = History()
        window, loss = 0, None
        for step, batch in enumerate(iterator):
            if step >= steps:
                break
            loss = self.train_step(batch)
            if (step + 1) % log_every == 0:
                history.on_epoch_end(window, {"loss": float(loss)})
                window += 1
        if loss is not None and steps % log_every:
            history.on_epoch_end(window, {"loss": float(loss)})
        self.history = history
        return history

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def make_serving_fn(self) -> Callable[[Batch], torch.Tensor]:
        """Scorer over the model's current parameters: moves the batch to the
        device and returns the prediction there (``[B]``, or ``[B, N]`` for
        candidate rows). It needs no label column."""
        model = self.model

        def serve(batch: Batch) -> torch.Tensor:
            tensors = self._to_device(batch)
            with torch.inference_mode():
                prediction, _ = model(tensors, train=False)
            return prediction

        return serve
