"""Float feature column with normalization modes (port of
``pytorchrec_tpu/feature_column/numeric.py``): nop / max-min / z-score, with
the statistics captured when the schema is built.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Mapping, Optional

import numpy as np
import torch

from pytorchrec_tpu_torch.feature_column.base import DenseColumn


class NormalizationMode(Enum):
    NOP = "nop"
    MAX_MIN = "max_min"
    Z_SCORE = "z_score"


class NumericColumn(DenseColumn):
    def __init__(
        self,
        feature_name: str,
        normalization_mode: NormalizationMode = NormalizationMode.NOP,
        min_value: float = 0.0,
        max_value: float = 1.0,
        mean_value: float = 0.0,
        std_value: float = 1.0,
    ):
        super().__init__(feature_name)
        self.normalization_mode = normalization_mode
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.mean_value = float(mean_value)
        self.std_value = float(std_value)

    def get_feature_data(self, batch: Mapping[str, Any]) -> Optional[Any]:
        data = batch.get(self.feature_name)
        if data is None:
            return None
        data = torch.as_tensor(data).to(torch.float32)
        if self.normalization_mode == NormalizationMode.MAX_MIN:
            span = self.max_value - self.min_value
            return (data - self.min_value) / (span if span != 0 else 1.0)
        if self.normalization_mode == NormalizationMode.Z_SCORE:
            return (data - self.mean_value) / (self.std_value if self.std_value != 0 else 1.0)
        return data

    @classmethod
    def from_array(
        cls,
        feature_name: str,
        array,
        normalization_mode: NormalizationMode = NormalizationMode.NOP,
    ) -> "NumericColumn":
        array = np.asarray(array, dtype=np.float64)
        return cls(
            feature_name=feature_name,
            normalization_mode=normalization_mode,
            min_value=float(array.min()),
            max_value=float(array.max()),
            mean_value=float(array.mean()),
            std_value=float(array.std()),
        )

    from_series = from_array
