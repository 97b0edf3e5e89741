"""Dataset schema records and the split and train modes (port of
``pytorchrec_tpu/data/schema.py``).

``Trainer.fit`` reads a reader's ``train_mode``: under ``PAIR_WISE`` it
draws the epoch's negatives (``reader.train_neg_sample()``) before each
epoch. ``DatasetDescription`` is a dataset's schema, written beside its
frames as ``description.json`` (and a ``description.txt`` to read), in the
JAX package's layout: either package reads the other's.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Any, Dict, List

import numpy as np

from pytorchrec_tpu_torch.utils import constants as C


class SplitMode(Enum):
    SEQUENTIAL_SPLIT = "sequential_split"
    LEAVE_K_OUT = "leave_k_out"


class TrainMode(Enum):
    POINT_WISE = "point_wise"
    PAIR_WISE = "pair_wise"


@dataclass
class FeatureMeta:
    feature_name: str
    feature_type: str  # numeric / categorical / numeric_list / categorical_list
    info: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DatasetDescription:
    """Per-dataset schema: canonical columns, feature lists, interaction stats."""

    info: str = ""
    uid_column: str = C.UID
    iid_column: str = C.IID
    rate_column: str = C.RATE
    label_column: str = C.LABEL
    time_column: str = C.TIME
    base_features: List[FeatureMeta] = field(default_factory=list)
    context_features: List[FeatureMeta] = field(default_factory=list)
    user_features: List[FeatureMeta] = field(default_factory=list)
    item_features: List[FeatureMeta] = field(default_factory=list)
    user_interaction_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def compute_interaction_stats(self, uids: np.ndarray, labels: np.ndarray) -> None:
        """min/max/mean/median/std of the per-user interaction counts, over
        all rows, the positive and the negative ones."""
        uids = np.asarray(uids)
        labels = np.asarray(labels)
        for name, mask in [
            (C.ALL, np.ones_like(labels, dtype=bool)),
            (C.POSITIVE, labels == 1),
            (C.NEGATIVE, labels == 0),
        ]:
            selected = uids[mask]
            if len(selected) == 0:
                counts = np.zeros(1)
            else:
                _, counts = np.unique(selected, return_counts=True)
            self.user_interaction_stats[name] = {
                C.MIN: float(counts.min()),
                C.MAX: float(counts.max()),
                C.MEAN: float(counts.mean()),
                C.MEDIAN: float(np.median(counts)),
                C.STD: float(counts.std()),
            }

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def save(self, dataset_name: str) -> None:
        path = os.path.join(C.dataset_dir(), dataset_name)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, C.DESCRIPTION_JSON), "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)
        with open(os.path.join(path, C.DESCRIPTION_TXT), "w") as f:
            f.write(str(self))

    @classmethod
    def load(cls, dataset_name: str) -> "DatasetDescription":
        path = os.path.join(C.dataset_dir(), dataset_name, C.DESCRIPTION_JSON)
        with open(path) as f:
            raw = json.load(f)
        for key in (C.BASE_FEATURES, C.CONTEXT_FEATURES, C.USER_FEATURES, C.ITEM_FEATURES):
            if key in raw:
                raw[key] = [FeatureMeta(**m) for m in raw[key]]
        return cls(**raw)

    def __str__(self) -> str:
        lines = [f"DatasetDescription: {self.info}"]
        for label, features in [
            ("base", self.base_features),
            ("context", self.context_features),
            ("user", self.user_features),
            ("item", self.item_features),
        ]:
            lines.append(f"  {label} features:")
            for meta in features:
                lines.append(f"    {meta.feature_name} ({meta.feature_type}) {meta.info}")
        lines.append("  user interaction stats:")
        for kind, stats in self.user_interaction_stats.items():
            stat_str = ", ".join(f"{k}={v:.2f}" for k, v in stats.items())
            lines.append(f"    {kind}: {stat_str}")
        return "\n".join(lines)
