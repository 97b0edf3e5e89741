"""Jester joke-rating formatter (port of
``pytorchrec_tpu/data/process/datasets/jester.py``), without pandas.

Rows are ``uid \\t\\t iid \\t\\t rate`` triples (a float rating); the time is
the row's index, the label ``rate_to_label`` of the float rating, the rate
its ``int()`` (toward zero), and the rows keep the file's order.
"""

from __future__ import annotations

import logging
import os
from typing import Callable

import numpy as np

from pytorchrec_tpu_torch.data.process.datasets.movielens import (
    _base_features,
    _ids_and_sorted,
    _save_canonical,
)
from pytorchrec_tpu_torch.data.process.datasets.raw import as_int, map_values, read_table, renamed
from pytorchrec_tpu_torch.data.schema import DatasetDescription
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)


def format_jester(
    dataset_name: str = "Jester-PN",
    raw_name: str = "jester_ratings.dat",
    rate_to_label: Callable = None,
    info: str = "Jester, rate>0 positive",
) -> str:
    rate_to_label = rate_to_label or (lambda x: 1 if x > 0 else 0)
    raw_path = os.path.join(C.raw_data_dir(), raw_name)
    description = DatasetDescription(info=info)

    raw = renamed(read_table(raw_path, "\t\t"), [C.UID, C.IID, C.RATE])
    interactions = {
        C.UID: as_int(raw[C.UID], np.int32),
        C.IID: as_int(raw[C.IID], np.int32),
        C.RATE: as_int(map_values(raw[C.RATE], int), np.int32),
        C.LABEL: as_int(map_values(raw[C.RATE], rate_to_label), np.int32),
        C.TIME: np.arange(len(raw[C.UID]), dtype=np.int32),
    }

    users, items = _ids_and_sorted(interactions)
    description.base_features = _base_features()
    return _save_canonical(dataset_name, interactions, interactions, items, users, description)
