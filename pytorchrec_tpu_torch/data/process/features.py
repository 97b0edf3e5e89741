"""Feature preprocessing helpers (port of
``pytorchrec_tpu/data/process/features.py``): a scalar and a vectorized
bucketizer, and the sorted-unique int map.
"""

from __future__ import annotations

import math
from typing import AbstractSet, Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np


def get_bucketize_fn(boundaries: Sequence, log_base: Optional[int] = None) -> Callable:
    """Scalar bucketizer: category = #boundaries below value (left-closed)."""

    def bucketize_fn(value) -> int:
        if log_base:
            assert log_base > 1
            value = math.log(value, log_base)
        category = 0
        for boundary in boundaries:
            if value < boundary:
                break
            category += 1
        return category

    return bucketize_fn


def bucketize_array(values: np.ndarray, boundaries: Sequence,
                    log_base: Optional[int] = None) -> np.ndarray:
    """Vectorized bucketize with the same semantics as ``get_bucketize_fn``."""
    values = np.asarray(values, dtype=np.float64)
    if log_base:
        assert log_base > 1
        values = np.log(values) / np.log(log_base)
    return np.searchsorted(np.asarray(boundaries, dtype=np.float64), values, side="right").astype(np.int64)


def get_int_map(collection: Union[Sequence, Mapping, AbstractSet], start: int = 0) -> Dict[Any, int]:
    """Sorted-unique values -> contiguous ints from ``start``."""
    assert start >= 0, start
    keys = sorted(set(collection))
    return dict(zip(keys, range(start, len(keys) + start)))
