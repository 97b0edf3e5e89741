"""Training callbacks (port of ``pytorchrec_tpu/training/callbacks.py``):
the hook surface (``Callback``), its fan-out with batch-hook timing
(``CallbackList``), the per-epoch record (``History``), the Keras-style
progress bar (``Progbar``, ``ProgbarLogger``: verbose 0 silent, 1 a live
batch-level bar, 2 one summary line an epoch), and the fit loop's
``ModelCheckpoint`` (weights to a file and the best weights in RAM),
``EarlyStopping``, ``CSVLogger`` and ``TerminateOnNaN``. ``fit``,
``evaluate`` and ``predict`` build a ``CallbackList`` with a progress bar
when ``verbose != 0``.

Callbacks talk to the trainer, which owns the model and its state. A
callback that overrides a train-batch hook makes ``fit`` copy each step's
loss to the host (a sync a step); without one an epoch runs with no host
sync until its end.
"""

from __future__ import annotations

import collections
import csv
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

Logs = Dict[str, Any]


class Callback:
    """The hook surface."""

    def __init__(self):
        self.trainer = None
        self.params: Dict[str, Any] = {}

    def set_trainer(self, trainer) -> None:
        self.trainer = trainer

    def set_params(self, params: Dict[str, Any]) -> None:
        self.params = params

    def on_epoch_begin(self, epoch: int, logs: Optional[Logs] = None): ...
    def on_epoch_end(self, epoch: int, logs: Optional[Logs] = None): ...
    def on_train_batch_begin(self, batch: int, logs: Optional[Logs] = None): ...
    def on_train_batch_end(self, batch: int, logs: Optional[Logs] = None): ...
    def on_test_batch_begin(self, batch: int, logs: Optional[Logs] = None): ...
    def on_test_batch_end(self, batch: int, logs: Optional[Logs] = None): ...
    def on_predict_batch_begin(self, batch: int, logs: Optional[Logs] = None): ...
    def on_predict_batch_end(self, batch: int, logs: Optional[Logs] = None): ...
    def on_train_begin(self, logs: Optional[Logs] = None): ...
    def on_train_end(self, logs: Optional[Logs] = None): ...
    def on_test_begin(self, logs: Optional[Logs] = None): ...
    def on_test_end(self, logs: Optional[Logs] = None): ...
    def on_predict_begin(self, logs: Optional[Logs] = None): ...
    def on_predict_end(self, logs: Optional[Logs] = None): ...

    def implements_train_batch_hooks(self) -> bool:
        """Whether this callback wants the per-batch train hooks. Asked of
        the instance, so a callback such as ProgbarLogger can answer by its
        verbose mode."""
        return (
            type(self).on_train_batch_begin is not Callback.on_train_batch_begin
            or type(self).on_train_batch_end is not Callback.on_train_batch_end
        )


class History(Callback):
    """Per-epoch log accumulation and best-epoch selection: ``history[key]``
    holds the value logged at the end of each epoch (or each ``log_every``
    window of ``fit_steps``)."""

    def __init__(self):
        super().__init__()
        self.epoch: List[int] = []
        self.history: Dict[str, List[Any]] = {}

    def set_trainer(self, trainer) -> None:
        """A History needs no trainer, and keeps none: the trainer holds its
        last History, and a reference back would make a cycle that only
        Python's collector frees, the trainer's device memory with it."""

    def on_train_begin(self, logs=None):
        self.epoch = []
        self.history = {}

    def on_epoch_end(self, epoch: int, logs=None):
        logs = logs or {}
        self.epoch.append(epoch)
        for key, value in logs.items():
            self.history.setdefault(key, []).append(value)

    def get_best_epoch_logs(self, monitor: str, mode: str = "max"):
        """(best_epoch, logs_at_best) by the monitored metric."""
        values = self.history[monitor]
        best = int(np.argmax(values) if mode == "max" else np.argmin(values))
        return self.epoch[best], {k: v[best] for k, v in self.history.items()}


class CallbackList:
    """Dispatch to every callback, a History added where asked, and a
    warning when the batch hooks take most of a batch's time."""

    def __init__(
        self,
        callbacks: Optional[Sequence[Callback]] = None,
        add_history: bool = False,
        add_progbar: bool = False,
        trainer=None,
        **params,
    ):
        self.callbacks: List[Callback] = list(callbacks or [])
        self.history: Optional[History] = None
        for cb in self.callbacks:
            if isinstance(cb, History):
                self.history = cb
        if add_history and self.history is None:
            self.history = History()
            self.callbacks.append(self.history)
        if add_progbar and not any(isinstance(c, ProgbarLogger) for c in self.callbacks):
            self.callbacks.append(ProgbarLogger())
        if trainer is not None:
            self.set_trainer(trainer)
        if params:
            self.set_params(params)
        self._batch_times = collections.deque(maxlen=20)
        self._hook_times = collections.deque(maxlen=20)
        self._batch_start_time = 0.0
        self._warned_slow = False

    def set_trainer(self, trainer) -> None:
        self.trainer = trainer
        for cb in self.callbacks:
            cb.set_trainer(trainer)

    def set_params(self, params: Dict[str, Any]) -> None:
        self.params = params
        for cb in self.callbacks:
            cb.set_params(params)

    def append(self, callback: Callback) -> None:
        self.callbacks.append(callback)

    def implements_train_batch_hooks(self) -> bool:
        """True when any callback overrides a train-batch hook: the trainer
        skips the per-batch device-to-host loss copy when none listens."""
        return any(cb.implements_train_batch_hooks() for cb in self.callbacks)

    def _call(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(*args)

    # epoch / train / test / predict hooks -----------------------------------
    def on_epoch_begin(self, epoch: int, logs: Optional[Logs] = None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch: int, logs: Optional[Logs] = None):
        self._call("on_epoch_end", epoch, logs)

    def on_train_begin(self, logs: Optional[Logs] = None):
        self._call("on_train_begin", logs)

    def on_train_end(self, logs: Optional[Logs] = None):
        self._call("on_train_end", logs)

    def on_test_begin(self, logs: Optional[Logs] = None):
        self._call("on_test_begin", logs)

    def on_test_end(self, logs: Optional[Logs] = None):
        self._call("on_test_end", logs)

    def on_predict_begin(self, logs: Optional[Logs] = None):
        self._call("on_predict_begin", logs)

    def on_predict_end(self, logs: Optional[Logs] = None):
        self._call("on_predict_end", logs)

    # batch hooks with timing ------------------------------------------------
    def on_train_batch_begin(self, batch: int, logs: Optional[Logs] = None):
        self._batch_start_time = time.monotonic()
        self._call("on_train_batch_begin", batch, logs)

    def on_train_batch_end(self, batch: int, logs: Optional[Logs] = None):
        batch_time = time.monotonic() - self._batch_start_time
        start = time.monotonic()
        self._call("on_train_batch_end", batch, logs)
        hook_time = time.monotonic() - start
        self._batch_times.append(batch_time)
        self._hook_times.append(hook_time)
        if (
            not self._warned_slow
            and len(self._batch_times) == self._batch_times.maxlen
            and sum(self._hook_times) > 0.95 * sum(self._batch_times)
            and sum(self._batch_times) > 0
        ):
            self._warned_slow = True
            logger.warning(
                "callbacks are consuming >95%% of batch time "
                "(batch %.4fs vs hooks %.4fs)",
                np.mean(self._batch_times), np.mean(self._hook_times),
            )

    def on_test_batch_begin(self, batch: int, logs: Optional[Logs] = None):
        self._call("on_test_batch_begin", batch, logs)

    def on_test_batch_end(self, batch: int, logs: Optional[Logs] = None):
        self._call("on_test_batch_end", batch, logs)

    def on_predict_batch_begin(self, batch: int, logs: Optional[Logs] = None):
        self._call("on_predict_batch_begin", batch, logs)

    def on_predict_batch_end(self, batch: int, logs: Optional[Logs] = None):
        self._call("on_predict_batch_end", batch, logs)


class Progbar:
    """Keras-style terminal progress bar.

    verbose 1 renders ``N/M [=====>....] - 12s - ETA: 3s - loss: 0.6931``
    with in-place ``\\r`` redraw on interactive terminals and throttled
    newline snapshots otherwise (every 10 s, so piped job logs stay
    readable); verbose 2 prints one summary line at finalize.
    """

    def __init__(
        self,
        target: Optional[int] = None,
        width: int = 30,
        verbose: int = 1,
        interval: Optional[float] = None,
        out=None,
    ):
        self.target = target
        self.width = width
        self.verbose = verbose
        self.out = out if out is not None else sys.stdout
        self._dynamic = hasattr(self.out, "isatty") and self.out.isatty()
        self.interval = interval if interval is not None else (0.05 if self._dynamic else 10.0)
        self.seen = 0
        self._values: Dict[str, Any] = {}
        self._order: List[str] = []
        self._start = time.monotonic()
        self._last_update = 0.0

    @staticmethod
    def _fmt_value(value) -> str:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return str(value)
        return f"{v:.4f}" if abs(v) > 1e-3 else f"{v:.4e}"

    def _bar(self, current: int) -> str:
        # "  7/100 [==>...........................]"
        if self.target is None:
            return f"{current:7d}/Unknown"
        digits = len(str(self.target))
        filled = int(self.width * current / self.target) if self.target else self.width
        bar = "=" * max(filled - 1, 0)
        if filled > 0:
            bar += "=" if current >= self.target else ">"
        bar += "." * (self.width - filled)
        return f"{current:{digits}d}/{self.target} [{bar}]"

    @staticmethod
    def _fmt_eta(eta: float) -> str:
        if eta > 3600:
            return "%d:%02d:%02d" % (eta // 3600, (eta % 3600) // 60, eta % 60)
        if eta > 60:
            return "%d:%02d" % (eta // 60, eta % 60)
        return "%ds" % eta

    @staticmethod
    def _fmt_rate(time_per_unit: float) -> str:
        if time_per_unit >= 1 or time_per_unit == 0:
            return f" {time_per_unit:.0f}s/batch"
        if time_per_unit >= 1e-3:
            return f" {time_per_unit * 1e3:.0f}ms/batch"
        return f" {time_per_unit * 1e6:.0f}us/batch"

    def update(
        self,
        current: int,
        values: Optional[List[Tuple[str, Any]]] = None,
        finalize: Optional[bool] = None,
    ) -> None:
        if finalize is None:
            finalize = self.target is not None and current >= self.target
        for k, v in values or []:
            if k not in self._order:
                self._order.append(k)
            self._values[k] = v
        self.seen = current
        now = time.monotonic()

        if self.verbose == 1:
            if now - self._last_update < self.interval and not finalize:
                return
            elapsed = now - self._start
            info = ("\r" if self._dynamic else "") + self._bar(current)
            info += f" - {elapsed:.0f}s"
            time_per_unit = elapsed / current if current else 0.0
            if self.target is None or finalize:
                info += self._fmt_rate(time_per_unit)
            else:
                info += " - ETA: " + self._fmt_eta(time_per_unit * (self.target - current))
            for k in self._order:
                info += f" - {k}: {self._fmt_value(self._values[k])}"
            if self._dynamic and not finalize:
                # pad over any leftover chars from a longer previous line
                pad = getattr(self, "_prev_len", 0) - len(info)
                self._prev_len = len(info)
                info += " " * max(pad, 0)
            else:
                info += "\n"
            self.out.write(info)
            self.out.flush()
        elif self.verbose == 2 and finalize:
            info = self._bar(current).split(" [")[0]
            info += f" - {now - self._start:.0f}s"
            for k in self._order:
                info += f" - {k}: {self._fmt_value(self._values[k])}"
            self.out.write(info + "\n")
            self.out.flush()
        self._last_update = now


class ProgbarLogger(Callback):
    """Progress display across fit/evaluate/predict: verbose 0 = silent, 1 = live batch-level
    progress bar, 2 = one summary line per epoch. At verbose 2 the
    batch-level train hooks are NOT implemented, so the trainer skips the
    per-batch device->host loss sync (CallbackList batch-hook
    introspection) — epoch summaries come from the epoch logs."""

    def __init__(self, verbose: Optional[int] = None, out=None):
        super().__init__()
        self._verbose_override = verbose
        self.verbose = verbose if verbose is not None else 1
        self.out = out
        self.epochs = 1
        self.target: Optional[int] = None
        self.seen = 0
        self.progbar: Optional[Progbar] = None
        self._called_in_fit = False

    def set_params(self, params: Dict[str, Any]) -> None:
        super().set_params(params)
        if self._verbose_override is None:
            self.verbose = params.get("verbose", 1)
        self.epochs = params.get("epochs", 1)
        self.target = params.get("batches")
        self._reset_progbar()

    def implements_train_batch_hooks(self) -> bool:
        return self.verbose == 1

    def _reset_progbar(self) -> None:
        self.seen = 0
        self.progbar = Progbar(target=self.target, verbose=self.verbose, out=self.out)

    def _batch_update(self, logs: Optional[Logs]) -> None:
        if self.progbar is None:
            self._reset_progbar()
        logs = dict(logs or {})
        logs.pop("batch", None)
        self.seen += 1
        self.progbar.update(self.seen, list(logs.items()), finalize=False)

    def _finalize(self, logs: Optional[Logs]) -> None:
        if self.progbar is None:
            self._reset_progbar()
        if self.target is None:
            self.target = self.seen
            self.progbar.target = self.seen
        # verbose 2 never saw batch hooks; report the full epoch as done
        current = self.seen if self.verbose == 1 else (self.target or self.seen)
        self.progbar.update(current, list((logs or {}).items()), finalize=True)

    # fit path ---------------------------------------------------------------
    def on_train_begin(self, logs=None):
        self._called_in_fit = True  # dev-eval inside fit stays silent

    def on_epoch_begin(self, epoch: int, logs=None):
        self._reset_progbar()
        if self.verbose and self.epochs > 1:
            out = self.out if self.out is not None else sys.stdout
            out.write(f"Epoch {epoch + 1}/{self.epochs}\n")
            out.flush()

    def on_train_batch_end(self, batch: int, logs=None):
        if self.verbose == 1:
            self._batch_update(logs)

    def on_epoch_end(self, epoch: int, logs=None):
        if self.verbose:
            self._finalize(logs)

    # standalone evaluate/predict -------------------------------------------
    def on_test_begin(self, logs=None):
        if not self._called_in_fit:
            self._reset_progbar()

    def on_test_batch_end(self, batch: int, logs=None):
        if self.verbose == 1 and not self._called_in_fit:
            self._batch_update(logs)

    def on_test_end(self, logs=None):
        if self.verbose and not self._called_in_fit:
            self._finalize(logs)

    def on_predict_begin(self, logs=None):
        self._reset_progbar()

    def on_predict_batch_end(self, batch: int, logs=None):
        if self.verbose == 1:
            self._batch_update(None)  # don't render prediction payloads

    def on_predict_end(self, logs=None):
        if self.verbose:
            self._finalize(None)


class ModelCheckpoint(Callback):
    """Save weights each epoch (or every N batches), optionally best-only on a
    monitored metric; also takes the trainer's in-RAM best-weights copy."""

    def __init__(
        self,
        filepath: Optional[str],
        monitor: str = "loss",
        mode: str = "min",
        save_best_only: bool = True,
        save_freq="epoch",  # "epoch" or int (batches)
    ):
        """``filepath=None`` is the in-RAM mode: track the best weights on the
        trainer (``save_best_weights``, a host copy) without writing any
        file."""
        super().__init__()
        self.filepath = filepath
        self.monitor = monitor
        self.mode = mode
        self.save_best_only = save_best_only
        self.save_freq = save_freq
        self.best = -np.inf if mode == "max" else np.inf
        self._batches_seen = 0

    def implements_train_batch_hooks(self) -> bool:
        return isinstance(self.save_freq, int)

    def _improved(self, current) -> bool:
        if self.mode == "max":
            return current > self.best
        return current < self.best

    def _save(self, logs: Optional[Logs]) -> None:
        logs = logs or {}
        if self.save_best_only:
            current = logs.get(self.monitor)
            if current is None:
                return
            if not self._improved(current):
                return
            self.best = current
            self.trainer.save_best_weights()
        if self.filepath is not None:
            self.trainer.save_weights(self.filepath)

    def on_epoch_end(self, epoch: int, logs=None):
        if self.save_freq == "epoch":
            self._save(logs)

    def on_train_batch_end(self, batch: int, logs=None):
        if isinstance(self.save_freq, int):
            self._batches_seen += 1
            if self._batches_seen % self.save_freq == 0:
                self._save(logs)


class EarlyStopping(Callback):
    """Patience, min_delta and baseline on a monitored value; sets
    ``trainer.stop_training``, and with ``restore_best_weights`` loads the
    trainer's best weights (``load_best_weights``, in place)."""

    def __init__(
        self,
        monitor: str = "loss",
        mode: str = "min",
        patience: int = 0,
        min_delta: float = 0.0,
        baseline: Optional[float] = None,
        restore_best_weights: bool = False,
    ):
        super().__init__()
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.restore_best_weights = restore_best_weights
        self.wait = 0
        self.stopped_epoch = 0
        self.best = -np.inf if mode == "max" else np.inf

    def _improved(self, current) -> bool:
        if self.mode == "max":
            return current > self.best + self.min_delta
        return current < self.best - self.min_delta

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.stopped_epoch = 0
        self.best = -np.inf if self.mode == "max" else np.inf
        if self.baseline is not None:
            self.best = self.baseline

    def on_epoch_end(self, epoch: int, logs=None):
        current = (logs or {}).get(self.monitor)
        if current is None:
            return
        if self._improved(current):
            self.best = current
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped_epoch = epoch
            self.trainer.stop_training = True
            if self.restore_best_weights:
                self.trainer.load_best_weights()

    def on_train_end(self, logs=None):
        if self.stopped_epoch > 0:
            logger.info("early stopping at epoch %d", self.stopped_epoch + 1)


class CSVLogger(Callback):
    """A row of the epoch logs an epoch, flushed (tab-separated by default);
    on an early stop the remaining epochs are written as NA rows."""

    def __init__(self, filename: str, sep: str = "\t", append: bool = False):
        super().__init__()
        self.filename = filename
        self.sep = sep
        self.append = append
        self.keys: Optional[List[str]] = None
        self.writer = None
        self.file = None
        self._epochs_written = 0

    def on_train_begin(self, logs=None):
        os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
        self.file = open(self.filename, "a" if self.append else "w", newline="")
        self.writer = None
        self._epochs_written = 0

    def on_epoch_end(self, epoch: int, logs=None):
        logs = dict(logs or {})
        if self.writer is None:
            self.keys = ["epoch"] + sorted(logs.keys())
            self.writer = csv.DictWriter(self.file, fieldnames=self.keys, delimiter=self.sep)
            self.writer.writeheader()
        row = {"epoch": epoch}
        for key in self.keys[1:]:
            value = logs.get(key, "NA")
            row[key] = float(value) if isinstance(value, (int, float, np.floating)) else value
        self.writer.writerow(row)
        self.file.flush()
        self._epochs_written += 1

    def on_train_end(self, logs=None):
        total = self.params.get("epochs")
        if self.writer is not None and total is not None:
            for epoch in range(self._epochs_written, total):
                self.writer.writerow({"epoch": epoch, **{k: "NA" for k in self.keys[1:]}})
        if self.file is not None:
            self.file.close()
            self.file = None


class TerminateOnNaN(Callback):
    """Stop on a nan or inf batch loss. Its batch hook makes ``fit`` copy
    every step's loss to the host."""

    def on_train_batch_end(self, batch: int, logs=None):
        loss = (logs or {}).get("loss")
        if loss is not None and not np.isfinite(loss):
            logger.warning("batch %d: invalid loss %s, terminating training", batch, loss)
            self.trainer.stop_training = True
