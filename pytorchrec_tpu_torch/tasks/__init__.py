"""Task registry (port of ``pytorchrec_tpu/tasks/__init__.py``): ``normal``
(``Task``), ``repeat`` (``RepeatTask``) and ``grid_search``
(``GridSearch``), with the builder that assembles them from names."""

from pytorchrec_tpu_torch.tasks.builder import (
    build_model,
    build_reader,
    default_reader_kwargs,
    is_rl_model,
)
from pytorchrec_tpu_torch.tasks.grid_search import GridSearch, create_params_list
from pytorchrec_tpu_torch.tasks.repeat import RepeatTask
from pytorchrec_tpu_torch.tasks.task import ITask, Task
from pytorchrec_tpu_torch.utils.registry import Registry

TASKS: Registry = Registry("task")
TASKS.register("normal", Task)
TASKS.register("repeat", RepeatTask)
TASKS.register("grid_search", GridSearch)

task_name_list = list(TASKS.names())


def get_task_type(task_name: str):
    return TASKS.get(task_name)


__all__ = ["ITask", "Task", "RepeatTask", "GridSearch", "create_params_list", "build_model",
           "build_reader", "default_reader_kwargs", "is_rl_model", "TASKS", "task_name_list",
           "get_task_type"]
