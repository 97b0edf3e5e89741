"""XING RecSys-Challenge-2017 formatter (port of
``pytorchrec_tpu/data/process/datasets/xing.py``), without pandas.

* ``prepare_user_data``: career features, the country int-mapped, int8,
  sorted by uid;
* ``prepare_item_data``: career features, latitude and longitude in
  10-degree buckets (NaN -> 0), the month of ``created_at`` counted from
  the first year (``datetime64`` in place of ``pd.to_datetime``);
* ``prepare_interaction_data``: sorted by (uid, label), each (uid, iid)
  pair's last row kept, sorted by (uid, time); the interaction type to a
  rate by the challenge's scores and to a binary label;
* ``format_xing``: users with at least one positive, uid and iid remapped to
  contiguous 1-based ids over interaction ∩ features, merged, saved.

The ``prepare_*`` steps write ``pre_*.npz`` frames where the JAX package
writes ``pre_*.feather``, and return the frame; ``format_xing`` reads them.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from pytorchrec_tpu_torch.data.process.datasets.movielens import (
    BASE_COLUMNS,
    _base_features,
    _no_missing,
    _save_canonical,
)
from pytorchrec_tpu_torch.data.process.datasets.raw import (
    as_int,
    drop_duplicates_last,
    left_merge,
    map_values,
    read_table,
    renamed,
    stable_sort,
    take,
    where,
)
from pytorchrec_tpu_torch.data.process.features import get_int_map
from pytorchrec_tpu_torch.data.process.io import Frame, read_frame, write_frame
from pytorchrec_tpu_torch.data.schema import DatasetDescription, FeatureMeta
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)

COUNTRY_INT_MAP = {"non_dach": 0, "de": 1, "at": 2, "ch": 3}
LABEL_TO_RATE = {0: 0, 1: 1, 2: 5, 3: 5, 4: -10, 5: 20}
LABEL_TO_LABEL = {0: 0, 1: 1, 2: 1, 3: 1, 4: 0, 5: 1}

USER_FEATURES = [
    "u_c_career_level", "u_c_discipline_id", "u_c_industry_id", "u_c_country",
    "u_c_region", "u_c_experience_n_entries_class",
    "u_c_experience_years_experience", "u_c_experience_years_in_current",
    "u_c_edu_degree", "u_c_wtcj", "u_c_premium",
]
ITEM_FEATURES = [
    "i_c_career_level", "i_c_discipline_id", "i_c_industry_id", "i_c_country",
    "i_c_is_paid", "i_c_region", "i_c_latitude", "i_c_longitude",
    "i_c_employment", "i_c_created_at",
]
PRE_USER, PRE_ITEM, PRE_INTERACTION = "pre_user.npz", "pre_item.npz", "pre_interaction.npz"


def _drop(frame: Frame, *names: str) -> Frame:
    return {k: v for k, v in frame.items() if k not in names}


def prepare_user_data(raw_name: str = "XING", users_csv: str = "users.csv") -> Frame:
    raw_dir = os.path.join(C.raw_data_dir(), raw_name)
    users = renamed(read_table(os.path.join(raw_dir, users_csv), "\t", header=True),
                    [C.UID, "jobroles"] + USER_FEATURES[:3] + [
                        "u_c_country", "u_c_region", "u_c_experience_n_entries_class",
                        "u_c_experience_years_experience", "u_c_experience_years_in_current",
                        "u_c_edu_degree", "edu_fieldofstudies", "u_c_wtcj", "u_c_premium"])
    users = _drop(users, "jobroles", "edu_fieldofstudies")
    _no_missing(users, users_csv)
    users["u_c_country"] = map_values(users["u_c_country"], COUNTRY_INT_MAP)
    users[C.UID] = as_int(users[C.UID], np.int32)
    for feature in USER_FEATURES:
        users[feature] = as_int(users[feature], np.int8)
    users = stable_sort(users, [C.UID])
    write_frame(os.path.join(raw_dir, PRE_USER), users)
    return users


def _geo_bucket(degrees: np.ndarray, offset: float) -> np.ndarray:
    """10-degree buckets from 1; NaN -> 0."""
    degrees = np.asarray(degrees, dtype=np.float64)
    return np.where(np.isnan(degrees), 0,
                    (np.trunc(np.nan_to_num(degrees) + offset) / 10).astype(np.int64) + 1)


def _month_index(seconds: np.ndarray) -> np.ndarray:
    """``pd.to_datetime(seconds, unit="s")``'s (year - first year) * 12 +
    month, 0 where that is not positive or the time is missing."""
    seconds = np.asarray(seconds, dtype=np.float64)
    missing = np.isnan(seconds)
    stamps = np.floor(np.where(missing, 0, seconds)).astype(np.int64).astype("datetime64[s]")
    year = stamps.astype("datetime64[Y]").astype(np.int64) + 1970
    month = stamps.astype("datetime64[M]").astype(np.int64) % 12 + 1
    min_year = year[~missing].min() if (~missing).any() else np.nan
    index = np.where(missing, (-1 - min_year) * 12 - 1, (year - min_year) * 12 + month)
    return np.array([int(x) if x > 0 else 0 for x in index.tolist()], dtype=np.int64)


def prepare_item_data(raw_name: str = "XING", items_csv: str = "items.csv") -> Frame:
    raw_dir = os.path.join(C.raw_data_dir(), raw_name)
    items = renamed(read_table(os.path.join(raw_dir, items_csv), "\t", header=True), [
        C.IID, "title", "i_c_career_level", "i_c_discipline_id", "i_c_industry_id",
        "i_c_country", "i_c_is_paid", "i_c_region", "i_c_latitude", "i_c_longitude",
        "i_c_employment", "tags", "i_c_created_at"])
    items = _drop(items, "title", "tags")
    items["i_c_country"] = map_values(items["i_c_country"], COUNTRY_INT_MAP)
    items["i_c_latitude"] = _geo_bucket(items["i_c_latitude"], 90)
    items["i_c_longitude"] = _geo_bucket(items["i_c_longitude"], 180)
    items["i_c_created_at"] = _month_index(items["i_c_created_at"])
    items[C.IID] = as_int(items[C.IID], np.int32)
    for feature in ITEM_FEATURES:
        items[feature] = as_int(items[feature], np.int8)
    items = stable_sort(items, [C.IID])
    write_frame(os.path.join(raw_dir, PRE_ITEM), items)
    return items


def prepare_interaction_data(raw_name: str = "XING",
                             interactions_csv: str = "interactions.csv") -> Frame:
    raw_dir = os.path.join(C.raw_data_dir(), raw_name)
    interactions = renamed(read_table(os.path.join(raw_dir, interactions_csv), "\t",
                                      header=True), [C.UID, C.IID, C.LABEL, C.TIME])
    interactions = stable_sort(interactions, [C.UID, C.LABEL])
    interactions = drop_duplicates_last(interactions, [C.UID, C.IID])
    interactions = stable_sort(interactions, [C.UID, C.TIME])
    interactions[C.RATE] = as_int(map_values(interactions[C.LABEL], LABEL_TO_RATE), np.int8)
    interactions[C.LABEL] = as_int(map_values(interactions[C.LABEL], LABEL_TO_LABEL), np.int8)
    interactions = {c: interactions[c] for c in BASE_COLUMNS}
    write_frame(os.path.join(raw_dir, PRE_INTERACTION), interactions)
    return interactions


def _warm_interactions(interactions: Frame, warm_n: int) -> Frame:
    """The rows of users with at least ``warm_n`` positives."""
    users, counts = np.unique(interactions[C.UID][interactions[C.LABEL] == 1],
                              return_counts=True)
    return where(interactions, np.isin(interactions[C.UID], users[counts >= warm_n]))


def _remapped(frame: Frame, column: str, mapping: dict) -> Frame:
    """The rows whose ``column`` is a key of ``mapping``, the column mapped
    to int32."""
    frame = where(frame, np.isin(frame[column], list(mapping)))
    frame[column] = as_int(map_values(frame[column], mapping), np.int32)
    return frame


def format_xing(dataset_name: str = "XING-PN", raw_name: str = "XING",
                info: str = "XING RecSys 2017, challenge-scored labels") -> str:
    raw_dir = os.path.join(C.raw_data_dir(), raw_name)
    description = DatasetDescription(info=info)

    users = read_frame(os.path.join(raw_dir, PRE_USER))
    items = read_frame(os.path.join(raw_dir, PRE_ITEM))
    interactions = read_frame(os.path.join(raw_dir, PRE_INTERACTION))

    for feature in USER_FEATURES:
        meta = FeatureMeta(feature, C.CATEGORICAL_COLUMN)
        if feature == "u_c_country":
            meta.info[C.INT_MAP] = COUNTRY_INT_MAP
        description.user_features.append(meta)
    for feature in ITEM_FEATURES:
        meta = FeatureMeta(feature, C.CATEGORICAL_COLUMN)
        if feature == "i_c_country":
            meta.info[C.INT_MAP] = COUNTRY_INT_MAP
        description.item_features.append(meta)

    interactions = _warm_interactions(interactions, 1)

    iid_map = get_int_map(set(interactions[C.IID].tolist()) & set(items[C.IID].tolist()),
                          start=1)
    interactions = _remapped(interactions, C.IID, iid_map)
    items = stable_sort(_remapped(items, C.IID, iid_map), [C.IID])

    uid_map = get_int_map(set(interactions[C.UID].tolist()) & set(users[C.UID].tolist()),
                          start=1)
    interactions = _remapped(interactions, C.UID, uid_map)
    users = stable_sort(_remapped(users, C.UID, uid_map), [C.UID])

    for column in (C.RATE, C.LABEL, C.TIME):  # the base columns' canonical int32
        interactions[column] = as_int(interactions[column], np.int32)
    description.base_features = _base_features()

    merged = left_merge(left_merge(interactions, users, C.UID), items, C.IID)
    return _save_canonical(dataset_name, interactions, merged, items, users, description)
