"""Feature column base classes (port of ``pytorchrec_tpu/feature_column/base.py``).

A feature column is a name-keyed accessor over a batch dict (here dicts of
numpy arrays or torch tensors), plus a small metadata bag.
"""

from __future__ import annotations

from abc import ABC
from typing import Any, Dict, Mapping, Optional

import torch


class FeatureColumn(ABC):
    def __init__(self, feature_name: str):
        self.feature_name = feature_name
        self._info: Dict[str, Any] = {}

    def set_info(self, key: str, value: Any) -> None:
        self._info[key] = value

    def get_info(self, key: str, default: Any = None) -> Any:
        return self._info.get(key, default)

    def get_feature_data(self, batch: Mapping[str, Any]) -> Optional[Any]:
        """Pull this column's array out of a batch dict (None if absent)."""
        return batch.get(self.feature_name)

    def __repr__(self):
        return f"{type(self).__name__}(feature_name={self.feature_name!r})"


class CategoricalColumn(FeatureColumn, ABC):
    """Adds the vocab size ``category_num``."""

    def __init__(self, feature_name: str, category_num: int):
        super().__init__(feature_name)
        self.category_num = int(category_num)

    def __repr__(self):
        return (
            f"{type(self).__name__}(feature_name={self.feature_name!r},"
            f" category_num={self.category_num})"
        )


class DenseColumn(FeatureColumn, ABC):
    """Marker base for dense (float) input columns."""


def as_int(array) -> Optional[torch.Tensor]:
    """Integer ids for embedding lookups: a ``torch.int64`` tensor on the
    array's own device (numpy input lands on the CPU)."""
    if array is None:
        return None
    return torch.as_tensor(array).to(torch.int64)
