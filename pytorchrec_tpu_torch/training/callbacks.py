"""Training callbacks (port of ``pytorchrec_tpu/training/callbacks.py``):
the ``History`` record for now. The other callbacks and the callback list
come with the fit loop (A7).
"""

from __future__ import annotations

from typing import Any, Dict, List


class History:
    """Log accumulation: ``history[key]`` holds the value logged at the end
    of each epoch (or each ``log_every`` window of ``fit_steps``)."""

    def __init__(self):
        self.epoch: List[int] = []
        self.history: Dict[str, List[Any]] = {}

    def on_epoch_end(self, epoch: int, logs: Dict[str, Any]) -> None:
        self.epoch.append(epoch)
        for key, value in logs.items():
            self.history.setdefault(key, []).append(value)
