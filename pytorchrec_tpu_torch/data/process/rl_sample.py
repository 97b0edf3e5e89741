"""Value-RL candidate action sets (port of
``pytorchrec_tpu/data/process/rl_sample.py``), over numpy frames.

For every interaction row the candidate set is the window of the user's
positives around the user's running positive counter (the counter
increments *before* sampling on label == 1 rows), ``sample_len // 2`` to the
left and right (the left gets the smaller half when odd), padded on the
right with the window's last id (``pad_or_cut_array``). A user with no
positives has the one-id history ``[0]``. Rows stay in dataset order, int32,
saved as ``RL_SAMPLE/rl_sample_<n>.npy`` and its ``.csv`` twin
(``save_index_array``): the JAX package's bytes.

The JAX function walks the rows one by one; here every row's window is
gathered at once from the users' concatenated positives, with the same
bounds, so the arrays are equal (``tests/test_torch_rl_data.py``).
"""

from __future__ import annotations

import logging
import os
import re
from typing import List

import numpy as np

from pytorchrec_tpu_torch.data.process.io import dataset_path, read_interactions, save_index_array
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)


def rl_next_item_sample(uids: np.ndarray, iids: np.ndarray, labels: np.ndarray,
                        sample_len: int) -> np.ndarray:
    """``[rows, sample_len]`` int32 candidate sets of the rows ``uids``,
    ``iids``, ``labels`` (dataset order)."""
    l_size = sample_len // 2
    r_size = sample_len - l_size
    n = len(uids)
    order = np.argsort(uids, kind="stable")
    s_uids = uids[order]
    s_pos = labels[order] == 1
    _, starts, counts = np.unique(s_uids, return_index=True, return_counts=True)
    user = np.repeat(np.arange(len(starts)), counts)
    # the running positive counter, this row included
    cum = np.cumsum(s_pos)
    before_user = np.concatenate([[0], cum])[starts]
    counter = cum - before_user[user]
    # each user's positives in row order, or [0] where it has none
    n_pos = np.add.reduceat(s_pos.astype(np.int64), starts) if n else np.zeros(0, np.int64)
    his_len = np.maximum(n_pos, 1)
    his_off = np.concatenate([[0], np.cumsum(his_len)])[:-1]
    his = np.zeros(int(his_len.sum()), dtype=np.int32)
    pos_rows = np.nonzero(s_pos)[0]
    rank = cum[pos_rows] - 1 - before_user[user[pos_rows]]
    his[his_off[user[pos_rows]] + rank] = iids[order][pos_rows].astype(np.int32)
    # window [max(0, c - l), min(c + r, len)), padded with its last id
    start = np.maximum(0, counter - l_size)
    end = np.minimum(counter + r_size, his_len[user])
    if (end <= start).any():
        raise IndexError("an empty candidate window (sample_len < 2 past a user's positives)")
    col = np.minimum(np.arange(sample_len)[None, :], (end - start - 1)[:, None])
    rows = his[(his_off[user] + start)[:, None] + col]
    out = np.empty_like(rows)
    out[order] = rows
    return out


def generate_rl_next_item_sample(dataset_name: str, sample_len: int) -> None:
    frame = read_interactions(dataset_name)
    rl_sample_dir = dataset_path(dataset_name, C.RL_SAMPLE_DIR)
    os.makedirs(rl_sample_dir, exist_ok=True)
    array = rl_next_item_sample(frame[C.UID], frame[C.IID], frame[C.LABEL], sample_len)
    save_index_array(rl_sample_dir, C.RL_SAMPLE_NPY_TEMPLATE % sample_len, array)
    logger.info("rl sample arrays (len=%d) for %d rows", sample_len, len(array))


def check_rl_next_item_sample(dataset_name: str) -> List[int]:
    rl_dir = dataset_path(dataset_name, C.RL_SAMPLE_DIR)
    if not os.path.isdir(rl_dir):
        return []
    pattern = re.compile(r"^rl_sample_(\d+).npy$")
    lens = []
    for filename in os.listdir(rl_dir):
        match = pattern.match(filename)
        if match:
            lens.append(int(match.group(1)))
    return sorted(lens)
