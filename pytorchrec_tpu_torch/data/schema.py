"""Split and train modes (port of ``pytorchrec_tpu/data/schema.py``'s enums).

``Trainer.fit`` reads a reader's ``train_mode``: under ``PAIR_WISE`` it
draws the epoch's negatives (``reader.train_neg_sample()``) before each
epoch. ``DatasetDescription`` comes with the readers.
"""

from __future__ import annotations

from enum import Enum


class SplitMode(Enum):
    SEQUENTIAL_SPLIT = "sequential_split"
    LEAVE_K_OUT = "leave_k_out"


class TrainMode(Enum):
    POINT_WISE = "point_wise"
    PAIR_WISE = "pair_wise"
