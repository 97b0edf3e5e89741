"""Cartesian cross of categorical columns via positional-radix encoding (port
of ``pytorchrec_tpu/feature_column/crossed.py``).

``cross_id = sum_i coef_i * id_i`` with ``coef_i = prod_{j>i} category_num_j``,
a single categorical id of vocab ``prod_i category_num_i``.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional

import torch

from pytorchrec_tpu_torch.feature_column.base import CategoricalColumn, as_int


class CrossedColumn(CategoricalColumn):
    def __init__(self, columns: List[CategoricalColumn]):
        if len(columns) < 2:
            raise ValueError("crossing needs at least two columns")
        name = "_X_".join(c.feature_name for c in columns)
        category_num = 1
        for c in columns:
            category_num *= c.category_num
        super().__init__(name, category_num)
        self.columns = columns
        coefs = []
        running = 1
        for c in reversed(columns):
            coefs.append(running)
            running *= c.category_num
        self.coefs = list(reversed(coefs))

    def get_feature_data(self, batch: Mapping[str, Any]) -> Optional[Any]:
        parts = []
        for coef, column in zip(self.coefs, self.columns):
            data = column.get_feature_data(batch)
            if data is None:
                return None
            parts.append(as_int(data) * coef)
        return torch.stack(parts, dim=0).sum(dim=0)
