"""Train-state checkpoints (port of ``pytorchrec_tpu/training/checkpoint.py``):
atomic and asynchronous saves with retention, periodic saves during ``fit``
and a preemption guard, restored in place.

Orbax becomes ``torch.save``: each file is written to ``<path>.tmp`` and
renamed over ``<path>`` (``os.replace``), so a reader finds a whole file or
none. ``CheckpointManager(directory)`` keeps ``<directory>/<step>.pt``
files, the newest ``max_to_keep`` of them; with ``async_save`` one writer
thread writes them, from host copies taken before ``save`` returns, so the
training that goes on cannot change what is written. A write that fails
raises: at the next ``save``, at ``wait`` or at ``close``.

What a file holds is ``Trainer.checkpoint_state()``: the weights by flax
path, the dense optimizer's state, the step, the dropout generator's state
and, for the quantized trainer, its accumulators and rounding key. A restore
copies them into the trainer's tensors (``Trainer.load_checkpoint_state``),
so CUDA graphs captured before it go on reading the restored values.

On a mesh (``parallel/mesh.py``) every rank takes the host copies (a
collective: the sharded tables are gathered) and rank 0 alone writes
(``Trainer.writes_files``). ``PreemptionGuard`` acts on its own signal in
one process; in a world of several it acts on the ranks' consensus, an
``all_reduce`` MAX of their flags every ``sync_every`` batches and at each
epoch's end, so that every rank stops, and saves, at the same step.
"""

from __future__ import annotations

import logging
import os
import re
import signal
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from pytorchrec_tpu_torch.training.callbacks import Callback

logger = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"(\d+)\.pt")


def atomic_save(obj: Any, filepath: str) -> None:
    """``torch.save(obj)`` to ``filepath + ".tmp"``, then renamed over
    ``filepath``; a failed write removes the temporary file and raises."""
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    tmp = filepath + ".tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, filepath)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


class CheckpointManager:
    """Step-numbered train-state files in one directory, the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: List[Future] = []

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def steps(self) -> List[int]:
        """The steps whose files are whole on disk, in order."""
        found = (_STEP_FILE.fullmatch(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, trainer) -> None:
        """Save ``trainer``'s state as ``step``: the host copies are taken
        here, the file is written now or, asynchronously, by the writer
        thread. A failed earlier write raises here. On a mesh every rank
        takes the copies and rank 0 writes."""
        self._collect()
        payload = trainer.checkpoint_state()
        if not getattr(trainer, "writes_files", True):
            return
        if self._writer is None:
            self._write(step, payload)
        else:
            self._pending.append(self._writer.submit(self._write, step, payload))

    def _write(self, step: int, payload) -> None:
        atomic_save(payload, self.path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def _collect(self, wait: bool = False) -> None:
        """Drop the finished writes, raising the first failure."""
        pending, self._pending = self._pending, []
        for i, future in enumerate(pending):
            if wait or future.done():
                future.result()  # a failed write raises here
            else:
                self._pending.extend(pending[i:])
                return

    def restore(self, trainer, step: Optional[int] = None) -> int:
        """Restore ``step`` (default: the latest on disk) into ``trainer``'s
        state, in place; returns the step."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        trainer.restore_checkpoint(self.path(step))
        return step

    def latest_step(self) -> Optional[int]:
        """The newest step whose file is whole on disk."""
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until every pending save is on disk; a failed one raises."""
        self._collect(wait=True)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)


class CheckpointCallback(Callback):
    """Full-state checkpoints every ``every_epochs`` epochs of ``fit``;
    ``maybe_resume`` picks up where the last whole save left off."""

    def __init__(self, directory: str, every_epochs: int = 1, max_to_keep: int = 3):
        super().__init__()
        self.ckpt = CheckpointManager(directory, max_to_keep=max_to_keep)
        self.every_epochs = every_epochs

    def on_epoch_end(self, epoch: int, logs=None):
        if (epoch + 1) % self.every_epochs == 0:
            self.ckpt.save(int(self.trainer.state.step), self.trainer)

    def on_train_end(self, logs=None):
        self.ckpt.wait()

    def maybe_resume(self) -> Optional[int]:
        """Restore the trainer's state from the latest checkpoint, if any
        (after ``init_state``); returns the restored step, or None."""
        step = self.ckpt.latest_step()
        if step is None:
            return None
        self.ckpt.restore(self.trainer, step)
        logger.info("resumed from checkpoint step %d", step)
        return step


class PreemptionGuard(CheckpointCallback):
    """Preemption-safe training: while ``fit`` runs, a handler for
    ``signals`` (default SIGTERM) only sets a flag; at the next batch (or
    epoch) boundary the guard saves the full train state synchronously and
    stops the loop, so a restart with ``maybe_resume`` continues exactly
    where the preempted run left off. The previous handlers come back at
    ``on_train_end``. Its batch hook makes ``fit`` sync each step. In one
    process the flag is its own, read after every batch; in a world of
    several ranks (one signalled, say) the ranks' consensus is read every
    ``sync_every`` batches and at each epoch's end, and every rank must
    reach those points the same number of times."""

    def __init__(self, directory: str, max_to_keep: int = 3, every_epochs: int = 0,
                 signals=None, sync_every: int = 10):
        # every_epochs=0: save only on preemption (pass >0 for periodic too)
        super().__init__(directory, every_epochs=every_epochs or 10**9,
                         max_to_keep=max_to_keep)
        self.signals = tuple(signals) if signals else (signal.SIGTERM,)
        self.sync_every = sync_every
        self.preempted = False
        self._previous = {}
        self._batches_seen = 0

    def on_train_begin(self, logs=None):
        self.preempted = False
        self._batches_seen = 0
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        logger.warning("preemption signal %d received; will checkpoint and stop at the next "
                       "step boundary", signum)
        self.preempted = True

    @staticmethod
    def _world() -> int:
        return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1

    def _consensus_preempted(self) -> bool:
        """Whether any process was preempted: this one's flag, or in a world
        of several the ``all_reduce`` MAX of every rank's (a collective)."""
        if self._world() == 1:
            return self.preempted
        flag = torch.tensor([int(self.preempted)], dtype=torch.int32, device=self.trainer.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def _save_and_stop(self):
        self.ckpt.save(int(self.trainer.state.step), self.trainer)
        self.ckpt.wait()  # on disk before the process can be killed
        if self._world() > 1:
            dist.barrier()  # every rank sees the file before it stops
        self.trainer.stop_training = True
        logger.warning("preemption checkpoint saved at step %d", int(self.trainer.state.step))

    def on_train_batch_end(self, batch: int, logs=None):
        if self.trainer.stop_training:
            return
        self._batches_seen += 1
        if self._world() > 1 and self._batches_seen % self.sync_every:
            return  # between the ranks' sync points
        if self._consensus_preempted():
            self._save_and_stop()

    def on_epoch_end(self, epoch: int, logs=None):
        super().on_epoch_end(epoch, logs)
        if not self.trainer.stop_training and self._consensus_preempted():
            self._save_and_stop()

    def on_train_end(self, logs=None):
        super().on_train_end(logs)
        for sig, previous in self._previous.items():
            signal.signal(sig, previous)
        self._previous = {}
