"""Processed-dataset discovery (port of
``pytorchrec_tpu/data/process/dataset_info.py``)."""

from __future__ import annotations

import os
from typing import List

from pytorchrec_tpu_torch.utils import constants as C


def check_dataset_info() -> List[str]:
    root = C.dataset_dir()
    if not os.path.isdir(root):
        return []
    return sorted(
        name for name in os.listdir(root) if os.path.isdir(os.path.join(root, name))
    )
