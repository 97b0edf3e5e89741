"""Amazon review-JSON formatters, Beauty / Cellphones / Grocery / any (port
of ``pytorchrec_tpu/data/process/datasets/amazon.py``), without pandas.

The 5-core review JSON lines are read a line at a time; reviewerID and
asin are int-mapped 1-based over their sorted text (0 stays the PAD id,
the JAX package's deliberate difference from the reference), the 5-star
rate becomes a binary label, the rows sort by (uid, time) with a stable
sort, and the canonical tables are written as in ``movielens.py``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Union

import numpy as np

from pytorchrec_tpu_torch.data.process.datasets.movielens import (
    BASE_COLUMNS,
    _apply_label,
    _base_features,
    _ids_and_sorted,
    _save_canonical,
)
from pytorchrec_tpu_torch.data.process.datasets.raw import as_int, map_values, stable_sort
from pytorchrec_tpu_torch.data.process.features import get_int_map
from pytorchrec_tpu_torch.data.schema import DatasetDescription
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)


def format_amazon(
    dataset_name: str,
    raw_json_name: str,
    rate_to_label: Union[Dict, None] = None,
    info: str = "Amazon 5-core reviews, rate>=4 positive",
) -> str:
    rate_to_label = rate_to_label or {1: 0, 2: 0, 3: 0, 4: 1, 5: 1}
    raw_path = os.path.join(C.raw_data_dir(), raw_json_name)
    description = DatasetDescription(info=info)

    uids, iids, rates, times = [], [], [], []
    with open(raw_path) as f:
        for line in f:
            row = json.loads(line)
            uids.append(row["reviewerID"])
            iids.append(row["asin"])
            rates.append(int(row["overall"]))
            times.append(row["unixReviewTime"])

    interactions = {}
    for column, values in ((C.UID, uids), (C.IID, iids)):
        interactions[column] = as_int(map_values(np.array(values, dtype=object),
                                                 get_int_map(values, start=1)), np.int32)
    interactions[C.RATE] = np.array(rates, dtype=np.int64).astype(np.int32)
    _apply_label(interactions, rate_to_label)
    interactions[C.TIME] = as_int(np.array(times), np.int32)
    interactions = stable_sort({c: interactions[c] for c in BASE_COLUMNS}, [C.UID, C.TIME])

    users, items = _ids_and_sorted(interactions)
    description.base_features = _base_features()
    return _save_canonical(dataset_name, interactions, interactions, items, users, description)


def format_amazon_beauty(dataset_name: str = "Amazon-Beauty-PN", **kwargs) -> str:
    return format_amazon(dataset_name, "reviews_Beauty_5.json", **kwargs)


def format_amazon_cellphones(dataset_name: str = "Amazon-Cellphones-PN", **kwargs) -> str:
    return format_amazon(dataset_name, "reviews_Cell_Phones_and_Accessories_5.json", **kwargs)


def format_amazon_grocery(dataset_name: str = "Amazon-Grocery-PN", **kwargs) -> str:
    return format_amazon(dataset_name, "reviews_Grocery_and_Gourmet_Food_5.json", **kwargs)
