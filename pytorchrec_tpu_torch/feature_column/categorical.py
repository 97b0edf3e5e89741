"""Integer-id categorical column (port of
``pytorchrec_tpu/feature_column/categorical.py``).

``from_array`` sets the vocab size to ``max + 1`` and records min/max in the
metadata bag.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np

from pytorchrec_tpu_torch.feature_column.base import CategoricalColumn, as_int

MIN_VALUE = "min_value"
MAX_VALUE = "max_value"


class CategoricalColumnWithIdentity(CategoricalColumn):
    def get_feature_data(self, batch: Mapping[str, Any]) -> Optional[Any]:
        data = batch.get(self.feature_name)
        if data is None:
            return None
        return as_int(data)

    @classmethod
    def from_array(cls, feature_name: str, array) -> "CategoricalColumnWithIdentity":
        array = np.asarray(array)
        column = cls(feature_name=feature_name, category_num=int(array.max()) + 1)
        column.set_info(MIN_VALUE, int(array.min()))
        column.set_info(MAX_VALUE, int(array.max()))
        return column

    @classmethod
    def from_series(cls, feature_name: str, series) -> "CategoricalColumnWithIdentity":
        return cls.from_array(feature_name, np.asarray(series))
