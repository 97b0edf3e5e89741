"""Logging and filesystem helpers (port of ``pytorchrec_tpu/utils/system.py``)."""

from __future__ import annotations

import logging
import os

from pytorchrec_tpu_torch.utils import constants as C

_LOG_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def init_console_logger(level: int = logging.INFO) -> None:
    """Configure a single console logging handler."""
    logging.basicConfig(level=level, format=_LOG_FORMAT, force=True)


def check_dir_and_mkdir(path: str) -> None:
    """Create ``path`` (or its parent for file paths) if missing."""
    if os.path.splitext(path)[1]:
        path = os.path.dirname(path)
    if path:
        os.makedirs(path, exist_ok=True)


def check_important_dirs_and_mkdir() -> None:
    """Create the standard work-dir layout."""
    for path in [
        C.work_dir(),
        C.raw_data_dir(),
        C.dataset_dir(),
        C.log_dir(),
        C.model_dir(),
        C.grid_search_dir(),
        C.repeat_task_dir(),
        C.checkpoint_dir(),
    ]:
        os.makedirs(path, exist_ok=True)
