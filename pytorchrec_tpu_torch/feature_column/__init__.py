from pytorchrec_tpu_torch.feature_column.base import (
    CategoricalColumn,
    DenseColumn,
    FeatureColumn,
)
from pytorchrec_tpu_torch.feature_column.categorical import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.feature_column.crossed import CrossedColumn
from pytorchrec_tpu_torch.feature_column.numeric import NormalizationMode, NumericColumn

__all__ = [
    "FeatureColumn",
    "CategoricalColumn",
    "DenseColumn",
    "CategoricalColumnWithIdentity",
    "NumericColumn",
    "NormalizationMode",
    "CrossedColumn",
]
