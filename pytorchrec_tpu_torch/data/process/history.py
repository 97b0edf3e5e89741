"""Per-interaction history and RL next-state arrays (port of
``pytorchrec_tpu/data/process/history.py``), over numpy frames.

``(num_rows, k+1)`` int32, first column = history length (capped at k),
then the most recent <=k positive (and optionally negative) item ids,
left-aligned and zero-padded, under the JAX package's file names.

``history_matrix`` runs the native C++ loop (``native/fastrec.cpp``),
always: a failed build raises. ``_history_matrix`` is its numpy version,
the plain one the tests hold the native loop against: per user, the
concatenated positive-prefix array with k leading zeros, k-wide windows
ending at each row's prefix count, each rolled left so the zero padding
moves to the tail.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List

import numpy as np

from pytorchrec_tpu_torch import native
from pytorchrec_tpu_torch.data.process.io import dataset_path, read_interactions, save_index_array
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)


def pad_or_cut_array(array: np.ndarray, array_len: int, pad: int = 0) -> np.ndarray:
    """Pad on the right with ``pad`` or cut from the front to ``array_len``."""
    if len(array) < array_len:
        fill = np.full(array_len - len(array), pad, dtype=array.dtype)
        return np.concatenate([array, fill])
    if len(array) > array_len:
        return array[-array_len:]
    return array


def history_matrix(uids: np.ndarray, iids: np.ndarray, event_mask: np.ndarray,
                   k: int, inclusive: bool) -> np.ndarray:
    """The history arrays of one event stream, by the native loop (equal to
    ``_history_matrix``)."""
    return native.history_matrix(uids, iids, event_mask, k, inclusive)


def _history_matrix(uids: np.ndarray, iids: np.ndarray, event_mask: np.ndarray,
                    k: int, inclusive: bool) -> np.ndarray:
    """``(rows, k+1)`` history array for one event stream.

    ``event_mask`` marks rows whose iid enters the stream. ``inclusive=False``
    gives the *history* semantics (snapshot before appending the current row);
    ``inclusive=True`` gives the RL *next-state* semantics (append first).
    """
    n = len(uids)
    order = np.argsort(uids, kind="stable")
    inv_order = np.argsort(order, kind="stable")
    s_uids = uids[order]
    s_iids = iids[order].astype(np.int32)
    s_mask = event_mask[order]

    _, starts, counts = np.unique(s_uids, return_index=True, return_counts=True)
    user_of_row = np.repeat(np.arange(len(starts)), counts)

    # per-row count of events so far within the user (exclusive of this row)
    cum_events = np.cumsum(s_mask)
    base_events = np.concatenate([[0], cum_events])[starts]
    n_before = cum_events - s_mask.astype(np.int64) - np.repeat(base_events, counts)
    n_at = n_before + (s_mask.astype(np.int64) if inclusive else 0)

    # concatenated event-iid prefix arrays, each user padded with k zeros in front
    events_per_user = np.add.reduceat(s_mask.astype(np.int64), starts) if len(starts) else np.array([], dtype=np.int64)
    seg_lens = events_per_user + k
    seg_offsets = np.concatenate([[0], np.cumsum(seg_lens)])[:-1]
    concat = np.zeros(int(seg_lens.sum()), dtype=np.int32)
    # scatter each user's event iids after its k-zero prefix, in row order
    event_rows = np.nonzero(s_mask)[0]
    event_user = user_of_row[event_rows]
    event_rank = (cum_events[event_rows] - 1) - base_events[event_user]
    concat[seg_offsets[event_user] + k + event_rank] = s_iids[event_rows]

    # window ending at n_at: concat[off + n_at : off + n_at + k]
    # (k leading zeros make every window in-bounds)
    window_start = seg_offsets[user_of_row] + n_at
    gather_idx = window_start[:, None] + np.arange(k)[None, :]
    windows = concat[gather_idx]  # [rows, k]: zeros first, then the last <=k events

    lens = np.minimum(n_at, k).astype(np.int32)
    # roll each window left by (k - len) so events lead and zeros trail
    shift = (k - lens)[:, None]
    col = (np.arange(k)[None, :] + shift) % k
    aligned = np.take_along_axis(windows, col, axis=1)

    out = np.empty((n, k + 1), dtype=np.int32)
    out[:, 0] = lens
    out[:, 1:] = aligned
    return out[inv_order]


def _generate(dataset_name: str, k: int, inclusive: bool, out_dir_name: str,
              pos_template: str, neg_template: str) -> None:
    frame = read_interactions(dataset_name)
    out_dir = dataset_path(dataset_name, out_dir_name)
    os.makedirs(out_dir, exist_ok=True)

    uids = frame[C.UID]
    iids = frame[C.IID]
    labels = frame[C.LABEL]

    pos = history_matrix(uids, iids, labels > 0, k, inclusive)
    save_index_array(out_dir, pos_template % k, pos)

    if (labels == 0).any():
        neg = history_matrix(uids, iids, labels <= 0, k, inclusive)
        save_index_array(out_dir, neg_template % k, neg)
    logger.info("%s arrays (k=%d) for %s rows", out_dir_name, k, len(uids))


def generate_interaction_history_list(dataset_name: str, k: int) -> None:
    _generate(dataset_name, k, inclusive=False, out_dir_name=C.HISTORY_DIR,
              pos_template=C.POS_HIS_NPY_TEMPLATE, neg_template=C.NEG_HIS_NPY_TEMPLATE)


def generate_interaction_next_state_list(dataset_name: str, k: int) -> None:
    _generate(dataset_name, k, inclusive=True, out_dir_name=C.NEXT_STATE_DIR,
              pos_template=C.POS_NEXT_STATE_NPY_TEMPLATE,
              neg_template=C.NEG_NEXT_STATE_NPY_TEMPLATE)


def _check(dataset_name: str, dir_name: str, stem: str) -> List[int]:
    out_dir = dataset_path(dataset_name, dir_name)
    if not os.path.isdir(out_dir):
        return []
    pattern = re.compile(rf"^{stem}_(\d+).npy$")
    lens = []
    for filename in os.listdir(out_dir):
        match = pattern.match(filename)
        if match:
            lens.append(int(match.group(1)))
    return sorted(lens)


def check_interaction_history_list(dataset_name: str) -> List[int]:
    return _check(dataset_name, C.HISTORY_DIR, "pos_his")


def check_interaction_next_state_list(dataset_name: str) -> List[int]:
    return _check(dataset_name, C.NEXT_STATE_DIR, "pos_next_state")
