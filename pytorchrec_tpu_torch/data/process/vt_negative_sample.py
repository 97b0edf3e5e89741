"""Dev/test negative sampling (port of
``pytorchrec_tpu/data/process/vt_negative_sample.py``), over numpy frames.

Per user, ``2 * sample_n`` item ids the user never interacted with
positively, split into a dev half and a test half, saved as
``(num_users, sample_n)`` int32 arrays keyed by seed. Users come in the
order of their first row (pandas' ``unique``, not ``np.unique``'s sorted
order), so the arrays equal the JAX package's byte for byte.

Two modes:

* ``parity=True`` (default): scalar rejection draws, sorted-set, shuffle;
  the JAX package's exact generator calls.
* ``parity=False``: batched rejection sampling for very large datasets;
  same distribution, another stream.
"""

from __future__ import annotations

import logging
import os
import pickle as pkl
import re
from typing import Dict, List, Set

import numpy as np
from numpy.random import default_rng

from pytorchrec_tpu_torch.data.process.io import dataset_path, read_interactions, save_index_array
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)


def first_appearance(values: np.ndarray) -> np.ndarray:
    """The distinct values in the order of their first row (pandas' ``unique``)."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def generate_user_history_statistic(dataset_name: str) -> Dict[int, Set[int]]:
    """Build and write the per-user positive-item-set dict."""
    frame = read_interactions(dataset_name)
    neg_sample_dir = dataset_path(dataset_name, C.NEGATIVE_SAMPLE_DIR)
    os.makedirs(neg_sample_dir, exist_ok=True)

    uids = frame[C.UID]
    iids = frame[C.IID]
    labels = frame[C.LABEL]

    user_pos_his_set_dict: Dict[int, Set[int]] = {int(u): set() for u in np.unique(uids)}
    pos_mask = labels == 1
    for u, i in zip(uids[pos_mask].tolist(), iids[pos_mask].tolist()):
        user_pos_his_set_dict[int(u)].add(int(i))

    with open(os.path.join(neg_sample_dir, C.USER_POS_HIS_SET_DICT_PKL), "wb") as f:
        pkl.dump(user_pos_his_set_dict, f, pkl.HIGHEST_PROTOCOL)
    return user_pos_his_set_dict


def load_user_pos_his_set_dict(dataset_name: str) -> Dict[int, Set[int]]:
    path = dataset_path(dataset_name, C.NEGATIVE_SAMPLE_DIR, C.USER_POS_HIS_SET_DICT_PKL)
    if not os.path.exists(path):
        return generate_user_history_statistic(dataset_name)
    with open(path, "rb") as f:
        return pkl.load(f)


def _sample_user_parity(rng, inter_iid_set: Set[int], min_iid: int, max_iid: int,
                        sample_n: int) -> np.ndarray:
    """The JAX package's stream: scalar rejection until 2*sample_n unique
    unseen ids, then sorted, then shuffled."""
    sample_iid_set: Set[int] = set()
    for _ in range(sample_n * 2):
        iid = int(rng.integers(min_iid, max_iid))
        while iid in inter_iid_set or iid in sample_iid_set:
            iid = int(rng.integers(min_iid, max_iid))
        sample_iid_set.add(iid)
    samples = np.array(sorted(sample_iid_set)).astype(np.int32)
    rng.shuffle(samples)
    return samples


def _sample_user_fast(rng, inter_iid_set: Set[int], min_iid: int, max_iid: int,
                      sample_n: int) -> np.ndarray:
    """Vectorized rejection: oversample in batches, drop seen/duplicate ids."""
    need = sample_n * 2
    chosen: List[int] = []
    chosen_set: Set[int] = set()
    while len(chosen) < need:
        batch = rng.integers(min_iid, max_iid, size=max(4 * need, 64))
        for iid in batch.tolist():
            if iid in inter_iid_set or iid in chosen_set:
                continue
            chosen.append(iid)
            chosen_set.add(iid)
            if len(chosen) == need:
                break
    samples = np.array(sorted(chosen), dtype=np.int32)
    rng.shuffle(samples)
    return samples


def generate_vt_negative_sample(seed: int, dataset_name: str, sample_n: int,
                                parity: bool = True) -> None:
    neg_sample_dir = dataset_path(dataset_name, C.NEGATIVE_SAMPLE_DIR)
    os.makedirs(neg_sample_dir, exist_ok=True)

    rng = default_rng(seed)
    frame = read_interactions(dataset_name)
    uid_list = first_appearance(frame[C.UID])
    min_iid = 1  # 0: PAD
    max_iid = int(frame[C.IID].max()) + 1

    user_pos_his_set_dict = load_user_pos_his_set_dict(dataset_name)

    sample_fn = _sample_user_parity if parity else _sample_user_fast
    dev_rows: List[np.ndarray] = []
    test_rows: List[np.ndarray] = []
    for uid in uid_list:
        inter_iid_set = user_pos_his_set_dict[int(uid)]
        assert max_iid - min_iid - len(inter_iid_set) >= sample_n * 2, (
            f"user {uid}: not enough unseen items to sample {sample_n * 2}"
        )
        samples = sample_fn(rng, inter_iid_set, min_iid, max_iid, sample_n)
        dev_rows.append(samples[:sample_n])
        test_rows.append(samples[sample_n:])

    dev_array = np.vstack(dev_rows)
    test_array = np.vstack(test_rows)
    assert dev_array.dtype == np.int32 and test_array.dtype == np.int32

    save_index_array(neg_sample_dir, C.DEV_NEG_NPY_TEMPLATE % (seed, sample_n),
                     dev_array)
    save_index_array(neg_sample_dir, C.TEST_NEG_NPY_TEMPLATE % (seed, sample_n),
                     test_array)
    logger.info("vt negative sample: %s users x %s", dev_array.shape[0], sample_n)


def check_vt_negative_sample(dataset_name: str) -> List[int]:
    """Sample lengths available for both dev and test."""
    sample_dir = dataset_path(dataset_name, C.NEGATIVE_SAMPLE_DIR)
    if not os.path.isdir(sample_dir):
        return []
    sets = []
    for kind in ("test", "dev"):
        pattern = re.compile(rf"^{kind}_neg_(\d+)_(\d+).npy$")
        found = set()
        for filename in os.listdir(sample_dir):
            match = pattern.match(filename)
            if match:
                found.add(int(match.group(2)))
        sets.append(found)
    return sorted(sets[0] & sets[1])
