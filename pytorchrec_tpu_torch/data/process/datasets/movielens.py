"""MovieLens raw-data formatters, 100K / 1M / 10M (port of
``pytorchrec_tpu/data/process/datasets/movielens.py``), without pandas.

Each reads the raw GroupLens files from ``RawData/<raw_name>/`` (``|`` in
100K's ``u.user`` and ``u.item.utf8``, a tab in its ``u.data``, ``::`` in
1M's and 10M's ``.dat`` files), bucketizes and int-maps the features,
binarizes the label through ``rank_to_label``, sorts the interactions by
(uid, time) with a stable sort, and writes the canonical tables
(``_save_canonical``): each as a ``.npz`` frame and as the JAX package's
``.csv``, and the description. The same columns, order, dtypes and values
as the JAX package's feather tables; an int map's keys keep the type pandas
reads (ints sort as numbers, text as text).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Union

import numpy as np

from pytorchrec_tpu_torch.data.process.datasets.raw import (
    as_int,
    left_merge,
    map_values,
    read_table,
    renamed,
    stable_sort,
    take,
    write_table,
)
from pytorchrec_tpu_torch.data.process.features import bucketize_array, get_int_map
from pytorchrec_tpu_torch.data.process.io import Frame
from pytorchrec_tpu_torch.data.schema import DatasetDescription, FeatureMeta
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)

ML100K_GENRES = [
    "i_c_unknown", "i_c_action", "i_c_adventure", "i_c_animation", "i_c_children",
    "i_c_comedy", "i_c_crime", "i_c_documentary", "i_c_drama", "i_c_fantasy",
    "i_c_film_noir", "i_c_horror", "i_c_musical", "i_c_mystery", "i_c_romance",
    "i_c_sci_fi", "i_c_thriller", "i_c_war", "i_c_western",
]

ML1M_GENRE_MAP = {
    "Action": "i_c_action", "Adventure": "i_c_adventure", "Animation": "i_c_animation",
    "Children's": "i_c_children", "Comedy": "i_c_comedy", "Crime": "i_c_crime",
    "Documentary": "i_c_documentary", "Drama": "i_c_drama", "Fantasy": "i_c_fantasy",
    "Film-Noir": "i_c_film_noir", "Horror": "i_c_horror", "Musical": "i_c_musical",
    "Mystery": "i_c_mystery", "Romance": "i_c_romance", "Sci-Fi": "i_c_sci_fi",
    "Thriller": "i_c_thriller", "War": "i_c_war", "Western": "i_c_western",
}

U_AGE, U_GENDER, U_OCCUPATION = "u_c_age", "u_c_gender", "u_c_occupation"
I_YEAR = "i_c_year"
ML1M_AGE_BOUNDARIES = [18, 25, 35, 45, 50, 56]
GENDER_INT_MAP = {"M": 0, "F": 1}
BASE_COLUMNS = (C.UID, C.IID, C.RATE, C.LABEL, C.TIME)


def _apply_label(interactions: Frame, rank_to_label: Union[Dict, Callable]) -> None:
    interactions[C.LABEL] = as_int(map_values(interactions[C.RATE], rank_to_label), np.int32)


def _year_boundaries(years: np.ndarray) -> list:
    return [1940, 1950, 1960, 1970, 1980, 1985] + list(range(1990, int(years.max()) + 1))


def _base_features() -> list:
    return [FeatureMeta(name, C.CATEGORICAL_COLUMN) for name in BASE_COLUMNS]


def _ids_and_sorted(interactions: Frame) -> tuple:
    """The users' and items' one-column tables: each distinct id, sorted
    (``drop_duplicates().sort_values()``)."""
    return {C.UID: np.unique(interactions[C.UID])}, {C.IID: np.unique(interactions[C.IID])}


def _save_canonical(dataset_name: str, interactions: Frame, merged: Frame, items: Frame,
                    users: Frame, description: DatasetDescription) -> str:
    """The canonical tables, each as ``.csv`` and ``.npz``: the base
    interactions (uid, iid, rate, label, time of ``merged``), the merged
    interactions, the items and the users; then the interaction stats and
    the description."""
    out_dir = os.path.join(C.dataset_dir(), dataset_name)
    os.makedirs(out_dir, exist_ok=True)
    bad = {k: v.dtype for k, v in interactions.items() if v.dtype != np.int32}
    assert not bad, bad
    base = {c: merged[c] for c in BASE_COLUMNS}
    write_table(out_dir, C.BASE_INTERACTION_CSV, C.BASE_INTERACTION_FRAME, base)
    write_table(out_dir, C.INTERACTION_CSV, C.INTERACTION_FRAME, merged)
    write_table(out_dir, C.ITEM_CSV, C.ITEM_FRAME, items)
    write_table(out_dir, C.USER_CSV, C.USER_FRAME, users)
    description.compute_interaction_stats(merged[C.UID], merged[C.LABEL])
    description.save(dataset_name)
    return out_dir


def _no_missing(frame: Frame, what: str) -> None:
    for name, values in frame.items():
        if values.dtype.kind == "f" and np.isnan(values).any() or values.dtype == object and any(
                isinstance(v, float) and np.isnan(v) for v in values.tolist()):
            raise AssertionError(f"{what}: column {name!r} has missing values")


def format_movielens_100k(
    dataset_name: str = "MovieLens-100K-PN",
    raw_name: str = "MovieLens-100K",
    rank_to_label: Union[Dict, Callable] = None,
    info: str = "MovieLens-100K, rate>=4 positive",
) -> str:
    """The reference's ``proprecess/movielens-100k.py`` semantics."""
    rank_to_label = rank_to_label or {1: 0, 2: 0, 3: 0, 4: 1, 5: 1}
    raw_dir = os.path.join(C.raw_data_dir(), raw_name)
    description = DatasetDescription(info=info)

    # users: uid | age | gender | occupation
    users = renamed(read_table(os.path.join(raw_dir, "u.user"), "|", usecols=[0, 1, 2, 3]),
                    [C.UID, U_AGE, U_GENDER, U_OCCUPATION])
    _no_missing(users, "u.user")
    users[U_AGE] = bucketize_array(users[U_AGE], ML1M_AGE_BOUNDARIES).astype(np.int32)
    description.user_features.append(FeatureMeta(
        U_AGE, C.CATEGORICAL_COLUMN, {C.BUCKET_BOUNDARIES: ML1M_AGE_BOUNDARIES}))
    users[U_GENDER] = as_int(map_values(users[U_GENDER], GENDER_INT_MAP), np.int32)
    description.user_features.append(FeatureMeta(
        U_GENDER, C.CATEGORICAL_COLUMN, {C.INT_MAP: GENDER_INT_MAP}))
    occupation_map = get_int_map(users[U_OCCUPATION].tolist())
    users[U_OCCUPATION] = as_int(map_values(users[U_OCCUPATION], occupation_map), np.int32)
    description.user_features.append(FeatureMeta(
        U_OCCUPATION, C.CATEGORICAL_COLUMN, {C.INT_MAP: occupation_map}))
    users[C.UID] = as_int(users[C.UID], np.int32)

    # items: iid | title | release date | video date | url | 19 genre flags
    items = renamed(read_table(os.path.join(raw_dir, "u.item.utf8"), "|",
                               usecols=[0, 2] + list(range(5, 24)), dtypes={2: str}),
                    [C.IID, I_YEAR] + ML100K_GENRES)
    items[I_YEAR] = np.array(["-1" if isinstance(s, float) else s
                              for s in items[I_YEAR].tolist()], dtype=object)
    _no_missing(items, "u.item.utf8")
    years = np.array([int(str(s)[-4:]) for s in items[I_YEAR].tolist()], dtype=np.int64)
    boundaries = _year_boundaries(years)
    items[I_YEAR] = bucketize_array(years, boundaries).astype(np.int32)
    description.item_features.append(FeatureMeta(
        I_YEAR, C.CATEGORICAL_COLUMN, {C.BUCKET_BOUNDARIES: boundaries}))
    for genre in ML100K_GENRES:
        items[genre] = as_int(items[genre], np.int32)
        description.item_features.append(FeatureMeta(genre, C.CATEGORICAL_COLUMN))
    items[C.IID] = as_int(items[C.IID], np.int32)

    # interactions: uid \t iid \t rate \t time
    interactions = renamed(read_table(os.path.join(raw_dir, "u.data"), "\t", dtype=np.int32),
                           [C.UID, C.IID, C.RATE, C.TIME])
    _apply_label(interactions, rank_to_label)
    interactions = stable_sort({c: interactions[c] for c in BASE_COLUMNS}, [C.UID, C.TIME])
    description.base_features = _base_features()

    merged = left_merge(left_merge(interactions, users, C.UID), items, C.IID)
    return _save_canonical(dataset_name, interactions, merged, items, users, description)


def format_movielens_1m(
    dataset_name: str = "MovieLens-1M-PN",
    raw_name: str = "MovieLens-1M",
    rank_to_label: Union[Dict, Callable] = None,
    info: str = "MovieLens-1M, rate>=4 positive",
) -> str:
    """The reference's ``proprecess/movielens-1m.py`` semantics, with the
    iid remap to contiguous 1-based ids over interaction ∩ item."""
    rank_to_label = rank_to_label or {1: 0, 2: 0, 3: 0, 4: 1, 5: 1}
    raw_dir = os.path.join(C.raw_data_dir(), raw_name)
    description = DatasetDescription(info=info)

    users = renamed(read_table(os.path.join(raw_dir, "users.dat"), "::", usecols=[0, 1, 2, 3]),
                    [C.UID, U_GENDER, U_AGE, U_OCCUPATION])
    _no_missing(users, "users.dat")
    users[U_GENDER] = as_int(map_values(users[U_GENDER], GENDER_INT_MAP), np.int32)
    description.user_features.append(FeatureMeta(
        U_GENDER, C.CATEGORICAL_COLUMN, {C.INT_MAP: GENDER_INT_MAP}))
    age_map = get_int_map(users[U_AGE].tolist())
    users[U_AGE] = as_int(map_values(users[U_AGE], age_map), np.int32)
    description.user_features.append(FeatureMeta(
        U_AGE, C.CATEGORICAL_COLUMN, {C.INT_MAP: age_map}))
    users[U_OCCUPATION] = as_int(users[U_OCCUPATION], np.int32)
    description.user_features.append(FeatureMeta(U_OCCUPATION, C.CATEGORICAL_COLUMN))
    users[C.UID] = as_int(users[C.UID], np.int32)

    movies = renamed(read_table(os.path.join(raw_dir, "movies.dat"), "::", usecols=[0, 1, 2],
                                dtypes={1: str, 2: str}, encoding="latin-1"),
                     [C.IID, I_YEAR, "type"])
    years = np.array([int(str(s)[-5:-1]) for s in movies[I_YEAR].tolist()], dtype=np.int64)
    boundaries = _year_boundaries(years)
    items = {C.IID: movies[C.IID],
             I_YEAR: bucketize_array(years, boundaries).astype(np.int32)}
    description.item_features.append(FeatureMeta(
        I_YEAR, C.CATEGORICAL_COLUMN, {C.BUCKET_BOUNDARIES: boundaries}))
    # str.get_dummies(sep="|"): a flag a genre named in the row
    genres = [set(str(s).split("|")) if not isinstance(s, float) else set()
              for s in movies["type"].tolist()]
    for raw_genre, flag_name in ML1M_GENRE_MAP.items():
        items[flag_name] = np.array([raw_genre in g for g in genres], dtype=np.int32)
        description.item_features.append(FeatureMeta(flag_name, C.CATEGORICAL_COLUMN))
    _no_missing(items, "movies.dat")
    items[C.IID] = as_int(items[C.IID], np.int32)

    interactions = renamed(read_table(os.path.join(raw_dir, "ratings.dat"), "::",
                                      dtype=np.int32),
                           [C.UID, C.IID, C.RATE, C.TIME])
    _apply_label(interactions, rank_to_label)
    interactions = stable_sort({c: interactions[c] for c in BASE_COLUMNS}, [C.UID, C.TIME])

    # remap iids to contiguous 1-based over interaction ∩ item (0 stays PAD)
    iid_map = get_int_map(set(interactions[C.IID].tolist()) & set(items[C.IID].tolist()),
                          start=1)
    interactions[C.IID] = as_int(map_values(interactions[C.IID], iid_map), np.int32)
    items = take(items, np.flatnonzero(np.isin(items[C.IID], list(iid_map))))
    items[C.IID] = as_int(map_values(items[C.IID], iid_map), np.int32)
    items = stable_sort(items, [C.IID])

    description.base_features = _base_features()
    merged = left_merge(left_merge(interactions, users, C.UID), items, C.IID)
    return _save_canonical(dataset_name, interactions, merged, items, users, description)


def format_movielens_10m(
    dataset_name: str = "MovieLens-10M-PN",
    raw_name: str = "MovieLens-10M",
    rank_to_label: Callable = None,
    info: str = "MovieLens-10M, rate>=4 positive",
) -> str:
    """The reference's ``proprecess/movielens-10m.py`` semantics: no
    features, uid and iid remapped 1-based, float rates thresholded by a
    function."""
    rank_to_label = rank_to_label or (lambda x: 1 if x >= 4.0 else 0)
    raw_dir = os.path.join(C.raw_data_dir(), raw_name)
    description = DatasetDescription(info=info)

    interactions = renamed(read_table(os.path.join(raw_dir, "ratings.dat"), "::"),
                           [C.UID, C.IID, C.RATE, C.TIME])
    _no_missing(interactions, "ratings.dat")
    for column in (C.UID, C.IID):
        interactions[column] = as_int(map_values(
            interactions[column], get_int_map(interactions[column].tolist(), start=1)), np.int32)
    interactions[C.LABEL] = as_int(map_values(interactions[C.RATE], rank_to_label), np.int32)
    interactions[C.RATE] = as_int(interactions[C.RATE], np.int32)
    interactions[C.TIME] = as_int(interactions[C.TIME], np.int32)
    interactions = stable_sort({c: interactions[c] for c in BASE_COLUMNS}, [C.UID, C.TIME])

    users, items = _ids_and_sorted(interactions)
    description.base_features = _base_features()
    return _save_canonical(dataset_name, interactions, interactions, items, users, description)
