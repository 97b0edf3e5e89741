"""Train/dev/test split generation (port of
``pytorchrec_tpu/data/process/splits.py``), over numpy frames.

The same int32 index arrays under the same file names as the JAX package,
byte for byte: a frame's row index is ``np.arange(rows)`` (pandas'
``RangeIndex``), and users are grouped by a stable argsort.

* warm-user filter: keep users with >= ``warm_n`` positive (label==1) rows;
  ``warm_n == 0`` is promoted to 1.
* sequential split: per user (ascending uid), ``vt_num = floor(n * vt_ratio)``,
  first ``n - 2*vt_num`` rows train, next ``vt_num`` dev, last ``vt_num`` test.
* leave-k-out: users with >= ``warm_n + 2k`` positives contribute; the test
  set holds each user's last k positives, dev the previous k, and train
  everything strictly before the (2k)-th-from-last positive. Trailing
  negatives after those positives land in no split.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Tuple

import numpy as np

from pytorchrec_tpu_torch.data.process.io import dataset_path, read_interactions, save_index_array
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)


def _warm_user_mask(uids: np.ndarray, labels: np.ndarray, warm_n: int) -> np.ndarray:
    """Boolean row mask keeping users with >= warm_n positive interactions."""
    pos_uids = uids[labels == 1]
    unique, counts = np.unique(pos_uids, return_counts=True)
    warm_users = unique[counts >= warm_n]
    return np.isin(uids, warm_users)


def _save_split(dataset_name: str, split_name: str, train: np.ndarray, dev: np.ndarray,
                test: np.ndarray) -> None:
    split_dir = dataset_path(dataset_name, C.SPLIT_INDEX_DIR)
    save_index_array(split_dir, C.TRAIN_INDEX_NPY_TEMPLATE % split_name, train)
    save_index_array(split_dir, C.DEV_INDEX_NPY_TEMPLATE % split_name, dev)
    save_index_array(split_dir, C.TEST_INDEX_NPY_TEMPLATE % split_name, test)
    logger.info(
        "split %s: train=%d dev=%d test=%d", split_name, len(train), len(dev), len(test)
    )


def generate_sequential_split(dataset_name: str, warm_n: int, vt_ratio: float) -> None:
    frame = read_interactions(dataset_name)
    if warm_n == 0:
        warm_n = 1
    assert warm_n > 0, warm_n

    uids = frame[C.UID]
    labels = frame[C.LABEL]
    index = np.arange(len(uids), dtype=np.int32)

    mask = _warm_user_mask(uids, labels, warm_n)
    uids, index = uids[mask], index[mask]

    # group rows per user preserving row order; users ascend like groupby(UID)
    order = np.argsort(uids, kind="stable")
    sorted_uids = uids[order]
    sorted_index = index[order]
    _, starts, counts = np.unique(sorted_uids, return_index=True, return_counts=True)

    vt_nums = np.floor(counts * vt_ratio).astype(np.int64)
    train_nums = counts - 2 * vt_nums

    # per-row offset within its user group
    offsets = np.arange(len(sorted_uids)) - np.repeat(starts, counts)
    row_train_num = np.repeat(train_nums, counts)
    row_vt_num = np.repeat(vt_nums, counts)

    train = sorted_index[offsets < row_train_num]
    dev = sorted_index[(offsets >= row_train_num) & (offsets < row_train_num + row_vt_num)]
    test = sorted_index[offsets >= row_train_num + row_vt_num]

    split_name = C.SEQUENTIAL_SPLIT_NAME_TEMPLATE % (warm_n, vt_ratio)
    _save_split(dataset_name, split_name, train, dev, test)


def generate_leave_k_out_split(dataset_name: str, warm_n: int, k: int) -> None:
    frame = read_interactions(dataset_name)
    if warm_n == 0:
        warm_n = 1
    assert warm_n > 0, warm_n

    uids = frame[C.UID]
    labels = frame[C.LABEL]
    index = np.arange(len(uids), dtype=np.int32)

    warm_mask = _warm_user_mask(uids, labels, warm_n)
    vt_mask = _warm_user_mask(uids, labels, warm_n + 2 * k)

    uids_w, labels_w, index_w = uids[warm_mask], labels[warm_mask], index[warm_mask]
    vt_users = set(np.unique(uids[vt_mask]).tolist())

    order = np.argsort(uids_w, kind="stable")
    sorted_uids = uids_w[order]
    sorted_labels = labels_w[order]
    sorted_index = index_w[order]
    unique_users, starts, counts = np.unique(sorted_uids, return_index=True, return_counts=True)

    train_parts: List[np.ndarray] = []
    test_parts: List[np.ndarray] = []
    dev_parts: List[np.ndarray] = []
    for user, start, count in zip(unique_users, starts, counts):
        user_index = sorted_index[start : start + count]
        if user not in vt_users:
            train_parts.append(user_index)
            continue
        user_labels = sorted_labels[start : start + count]
        pos_positions = np.nonzero(user_labels == 1)[0]
        # last k positives -> test, previous k -> dev; train strictly before
        # the (2k)-th-from-last positive (trailing negatives are dropped)
        test_parts.append(user_index[pos_positions[-k:]])
        dev_parts.append(user_index[pos_positions[-2 * k : -k]])
        cutoff = pos_positions[-2 * k]
        train_parts.append(user_index[:cutoff])

    train = np.sort(np.concatenate(train_parts)).astype(np.int32)
    test = np.sort(np.concatenate(test_parts)).astype(np.int32)
    dev = np.sort(np.concatenate(dev_parts)).astype(np.int32)

    split_name = C.LEAVE_K_OUT_SPLIT_NAME_TEMPLATE % (warm_n, k)
    _save_split(dataset_name, split_name, train, dev, test)


def _check_splits(dataset_name: str, pattern_template: str, cast) -> List[Tuple]:
    split_dir = dataset_path(dataset_name, C.SPLIT_INDEX_DIR)
    if not os.path.isdir(split_dir):
        return []
    sets = []
    for kind in ("train", "dev", "test"):
        pattern = re.compile(pattern_template % kind)
        found = set()
        for filename in os.listdir(split_dir):
            match = pattern.match(filename)
            if match:
                found.add(tuple(c(g) for c, g in zip(cast, match.groups())))
        sets.append(found)
    return sorted(sets[0] & sets[1] & sets[2])


def check_sequential_split(dataset_name: str) -> List[Tuple[int, float]]:
    return _check_splits(dataset_name, r"^seq_split_(\d+)_(0.\d+).%s_index.npy$", (int, float))


def check_leave_k_out_split(dataset_name: str) -> List[Tuple[int, int]]:
    return _check_splits(dataset_name, r"^leave_k_out_(\d+)_(\d+).%s_index.npy$", (int, int))
