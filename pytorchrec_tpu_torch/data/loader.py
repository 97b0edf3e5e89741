"""Fixed-shape epoch batch iterators (port of ``pytorchrec_tpu/data/loader.py``).

Batches are whole-array slices off a columnar reader, and every batch of a
split has the same shape, so a captured step or scorer serves them all:

* train: a shuffled permutation, the last short batch dropped with
  ``drop_last``;
* eval and predict: sequential; the last short batch is padded by repeating
  its last row, and the number of real rows is yielded beside it so that
  callers cut the predictions before computing metrics.

A reader is any object with ``get_dataset_size(split)``,
``get_train_dataset_size()`` and ``get_batch(split, indices) -> {key: numpy
array}``; nothing else of it is read here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

Batch = Dict[str, np.ndarray]


def num_train_batches(dataset_size: int, batch_size: int, drop_last: bool = True) -> int:
    if drop_last:
        return dataset_size // batch_size
    return math.ceil(dataset_size / batch_size)


def train_batches(reader: Any, batch_size: int, rng: Optional[np.random.Generator] = None,
                  shuffle: bool = True, drop_last: bool = True) -> Iterator[Batch]:
    """One shuffled epoch of fixed-shape train batches."""
    size = reader.get_train_dataset_size()
    order = np.arange(size)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    for b in range(num_train_batches(size, batch_size, drop_last)):
        indices = order[b * batch_size:(b + 1) * batch_size]
        if len(indices) < batch_size and drop_last:
            break
        yield reader.get_batch("train", indices)


def eval_batches(reader: Any, split: str, batch_size: int) -> Iterator[Tuple[Batch, int]]:
    """Sequential fixed-shape batches; yields ``(batch, valid_row_count)``."""
    size = reader.get_dataset_size(split)
    for start in range(0, size, batch_size):
        stop = min(start + batch_size, size)
        indices = np.arange(start, stop)
        valid = len(indices)
        if valid < batch_size:
            pad = np.full(batch_size - valid, indices[-1], dtype=indices.dtype)
            indices = np.concatenate([indices, pad])
        yield reader.get_batch(split, indices), valid
