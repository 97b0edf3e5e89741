"""Step timing (port of ``pytorchrec_tpu/utils/profiling.py``'s
``StepTimer``).

``StepTimer`` reads the host clock around each train batch's hooks. Under
``Trainer.fit`` and ``fit_steps(steps_per_call=1)`` a callback with batch
hooks makes the trainer copy each step's loss to the host before
``on_train_batch_end``, which waits for the step, so the interval is the
step's own time (its batch's copy and the replay, or the warm-up).
``torch.profiler`` tracing comes with the task layer.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np

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
