"""Model base (port of ``pytorchrec_tpu/models/base.py``).

Every model takes feature-column objects and hyper-parameters at
construction and maps a batch dict to ``(prediction, target)``:

* point-wise rows: ``prediction [B]``, target = the label column as float
  (None when the batch carries no label, as when serving);
* candidate rows (``[B, N]``, positive first): ``prediction [B, N]``,
  target = one-hot-first.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

Batch = Dict[str, Any]
Prediction = Tuple[torch.Tensor, Optional[torch.Tensor]]


def one_hot_first_target(prediction: torch.Tensor) -> torch.Tensor:
    """Ranking target: ``[B, N]`` zeros with column 0 = 1 (the positive)."""
    target = torch.zeros_like(prediction, dtype=torch.float32)
    target[:, 0] = 1.0
    return target


def label_target(label_column, batch: Batch) -> Optional[torch.Tensor]:
    target = label_column.get_feature_data(batch) if label_column is not None else None
    if target is not None:
        target = torch.as_tensor(target).to(torch.float32)
    return target


class RecModel(nn.Module):
    """Base class for all rec models: ``forward(batch, train) -> (pred, target)``."""

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:  # pragma: no cover
        """``generator`` feeds dropout when ``train`` is True."""
        raise NotImplementedError

    @property
    def has_quantized_table(self) -> bool:
        """Whether a table is kept as quantized byte rows, which train only
        under ``QuantizedEmbeddingTrainer``."""
        return False
