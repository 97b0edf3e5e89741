"""Profiling (port of ``pytorchrec_tpu/utils/profiling.py``): step
timing, ``torch.profiler`` traces and NaN debugging.

``StepTimer`` reads the host clock around each train batch's hooks. Under
``Trainer.fit`` and ``fit_steps(steps_per_call=1)`` a callback with batch
hooks makes the trainer copy each step's loss to the host before
``on_train_batch_end``, which waits for the step, so the interval is the
step's own time (its batch's copy and the replay, or the warm-up).

``TorchProfiler`` (the JAX package's ``JaxProfiler``) traces a window of
train batches with ``torch.profiler`` (the CPU, and CUDA activity where
the trainer runs on the card) and writes a Chrome trace under ``log_dir``.

``enable_nan_debugging`` (the JAX package's ``jax_debug_nans``) turns on
autograd's anomaly mode with its NaN check: a backward function that
returns a NaN raises, naming the forward operation that made it. Its
checks read values back to the host, which a CUDA graph cannot capture,
so while it is on ``Trainer.fit`` and ``fit_steps`` step eagerly on the
card (``Trainer._captures``); ``disable_nan_debugging`` turns it off.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pytorchrec_tpu_torch.training.callbacks import Callback

logger = logging.getLogger(__name__)


class StepTimer(Callback):
    """Per-batch step timing with steady-state stats: ``skip_first`` batches
    are left out (a layout's warm-up step and its capture)."""

    def __init__(self, batch_size: Optional[int] = None, skip_first: int = 3):
        super().__init__()
        self.batch_size = batch_size
        self.skip_first = skip_first
        self.times: List[float] = []
        self._seen = 0
        self._start = 0.0

    def on_train_batch_begin(self, batch: int, logs=None):
        self._start = time.perf_counter()

    def on_train_batch_end(self, batch: int, logs=None):
        elapsed = time.perf_counter() - self._start
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(elapsed)

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        times = np.asarray(self.times)
        out = {
            "steps": int(len(times)),
            "mean_s": float(times.mean()),
            "p50_s": float(np.percentile(times, 50)),
            "p99_s": float(np.percentile(times, 99)),
        }
        if self.batch_size:
            out["examples_per_sec"] = float(self.batch_size / times.mean())
        return out

    def on_train_end(self, logs=None):
        if self.times:
            logger.info("step timing: %s", self.stats())


class TorchProfiler(Callback):
    """Trace train batches ``[start_batch, start_batch + num_batches)``
    (counted over the run) with ``torch.profiler``: CPU activity, and CUDA
    activity where the trainer runs on the card. The trace is written under
    ``log_dir`` as ``trace_<pid>_<n>.json`` (Chrome trace format, for
    ``chrome://tracing`` or Perfetto) when the window closes or training
    ends; ``trace_path`` names it. Its batch hooks make ``fit`` copy each
    step's loss to the host."""

    def __init__(self, log_dir: str, start_batch: int = 10, num_batches: int = 5):
        super().__init__()
        self.log_dir = log_dir
        self.start_batch = start_batch
        self.stop_batch = start_batch + num_batches
        self.trace_path: Optional[str] = None
        self._profiler = None
        self._seen = 0
        self._traces = 0

    def on_train_batch_begin(self, batch: int, logs=None):
        if self._seen == self.start_batch and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            device = getattr(self.trainer, "device", None)
            if device is not None and device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.log_dir, exist_ok=True)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            logger.info("torch profiler trace started -> %s", self.log_dir)

    def on_train_batch_end(self, batch: int, logs=None):
        self._seen += 1
        if self._seen == self.stop_batch and self._profiler is not None:
            self._stop()

    def on_train_end(self, logs=None):
        if self._profiler is not None:
            self._stop()

    def _stop(self) -> None:
        device = getattr(self.trainer, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        self._profiler.stop()
        self.trace_path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{self._traces}.json")
        self._profiler.export_chrome_trace(self.trace_path)
        self._profiler = None
        self._traces += 1
        logger.info("torch profiler trace written to %s", self.trace_path)


def enable_nan_debugging() -> None:
    """Autograd's anomaly mode with its NaN check: a NaN made in a train
    step raises in its backward, naming the forward operation. Train steps
    run eagerly while it is on (see the module docstring)."""
    torch.autograd.set_detect_anomaly(True, check_nan=True)


def disable_nan_debugging() -> None:
    torch.autograd.set_detect_anomaly(False)
