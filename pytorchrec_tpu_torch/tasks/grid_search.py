"""GridSearch: a cartesian sweep over model and optimizer hyperparameters
(port of ``pytorchrec_tpu/tasks/grid_search.py``). ``create_params_list``
expands base and search dicts into (params, log_params) pairs; one Task a
(model params x optimizer params) point; the results go to one
tab-separated file after every point (``tasks/results.py``: the file the
JAX task writes with pandas, written here with the ``csv`` module).
"""

from __future__ import annotations

import copy
import itertools
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

from pytorchrec_tpu_torch.data.process.io import Frame
from pytorchrec_tpu_torch.tasks.results import write_results
from pytorchrec_tpu_torch.tasks.task import ITask, Task
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)

ParamsPair = Tuple[Dict[str, Any], Dict[str, str]]


def create_params_list(base_params: Dict[str, Any],
                       search_params: Dict[str, List]) -> List[ParamsPair]:
    """(full params, log params) for each point of the grid."""
    ret: List[ParamsPair] = []
    axes = [[(name, v) for v in values] for name, values in search_params.items()]
    for point in itertools.product(*axes):
        full = copy.deepcopy(base_params)
        full.update(point)
        ret.append((full, {name: str(value) for name, value in point}))
    return ret


class GridSearch(ITask):
    def __init__(
        self,
        model_name: str,
        dataset: str,
        model_params_list: List[ParamsPair],
        optimizer_params_list: List[ParamsPair],
        reader_kwargs: Optional[Dict[str, Any]] = None,
        random_seed: int = 2020,
        device=None,
        **task_kwargs,
    ):
        self.model_name = model_name
        self.dataset = dataset
        self.model_params_list = model_params_list
        self.optimizer_params_list = optimizer_params_list
        self.reader_kwargs = dict(reader_kwargs or {})
        self.random_seed = random_seed
        self.device = device
        self.task_kwargs = task_kwargs
        loss = task_kwargs.get("loss", "bce")
        self.log_filename = os.path.join(
            C.grid_search_dir(), f"{model_name}_{dataset}_{loss}_grid_search.csv")

    def run(self) -> Frame:
        """Every point; returns the table's columns (a frame)."""
        task_logs: Dict[str, List] = {}
        frame: Frame = {}
        for model_params, model_log in self.model_params_list:
            for optimizer_params, optimizer_log in self.optimizer_params_list:
                params: Dict[str, Any] = {
                    "model": self.model_name,
                    "dataset": self.dataset,
                    "seed": self.random_seed,
                    **model_log,
                    **optimizer_log,
                }
                filename = "-".join(f"{k[:3]}-{v}" for k, v in params.items())
                task = Task.from_config(
                    self.model_name, self.dataset,
                    reader_kwargs={**self.reader_kwargs, "random_seed": self.random_seed},
                    model_kwargs=model_params, device=self.device,
                    random_seed=self.random_seed, filename=filename,
                    **{**self.task_kwargs, **optimizer_params})
                best_epoch, best_dev_logs, test_logs = task.run()
                params["best_epoch"] = best_epoch
                params.update({f"dev_{k}": v for k, v in best_dev_logs.items()})
                params.update({f"test_{k}": v for k, v in test_logs.items()})
                for key, value in params.items():
                    task_logs.setdefault(key, []).append(value)
                frame = write_results(self.log_filename, task_logs)
        return frame
