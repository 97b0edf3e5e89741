"""RepeatTask: one experiment run N times with shifted seeds (port of
``pytorchrec_tpu/tasks/repeat.py``): seed = base + repeat index for the
reader and the model's initialisation, each run's dev and test logs added
to one tab-separated file after every run (``tasks/results.py``: the file
the JAX task writes with pandas, written here with the ``csv`` module).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

from pytorchrec_tpu_torch.data.process.io import Frame
from pytorchrec_tpu_torch.tasks.results import write_results
from pytorchrec_tpu_torch.tasks.task import ITask, Task
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)


class RepeatTask(ITask):
    def __init__(
        self,
        repeat_num: int,
        model_name: str,
        dataset: str,
        reader_kwargs: Optional[Dict[str, Any]] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
        random_seed: int = 2020,
        device=None,
        **task_kwargs,
    ):
        self.repeat_num = repeat_num
        self.model_name = model_name
        self.dataset = dataset
        self.reader_kwargs = dict(reader_kwargs or {})
        self.model_kwargs = dict(model_kwargs or {})
        self.random_seed = random_seed
        self.device = device
        self.task_kwargs = task_kwargs
        loss = task_kwargs.get("loss", "bce")
        self.log_filename = os.path.join(
            C.repeat_task_dir(), f"{model_name}_{dataset}_{loss}_repeat_{repeat_num}.csv")

    def run(self) -> Frame:
        """Every run; returns the table's columns (a frame)."""
        task_logs: Dict[str, List] = {}
        frame: Frame = {}
        for repeat_index in range(self.repeat_num):
            seed = self.random_seed + repeat_index
            params: Dict[str, Any] = {
                "model": self.model_name,
                "dataset": self.dataset,
                "seed": seed,
                **{k: str(v) for k, v in self.model_kwargs.items()},
                **{k: str(v) for k, v in self.task_kwargs.items()},
            }
            task = Task.from_config(
                self.model_name, self.dataset,
                reader_kwargs={**self.reader_kwargs, "random_seed": seed},
                model_kwargs=self.model_kwargs, device=self.device, random_seed=seed,
                filename=f"{self.model_name}_{self.dataset}_repeat{repeat_index}",
                **self.task_kwargs)
            best_epoch, best_dev_logs, test_logs = task.run()
            params["best_epoch"] = best_epoch
            params.update({f"dev_{k}": v for k, v in best_dev_logs.items()})
            params.update({f"test_{k}": v for k, v in test_logs.items()})
            for key, value in params.items():
                task_logs.setdefault(key, []).append(value)
            frame = write_results(self.log_filename, task_logs)
            logger.info("repeat %d/%d done", repeat_index + 1, self.repeat_num)
        return frame
