"""Dataset adapters (port of ``pytorchrec_tpu/data/adapter.py``): per-split
views over a reader with ``__len__`` and ``__getitem__`` (one row as a
dict), for per-row access and export. Training and scoring read whole
batches (``data/loader.py``), not these.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from pytorchrec_tpu_torch.data.readers.base import DataReader


class _SplitDataset:
    split: str = ""

    def __init__(self, data_reader: DataReader):
        self.data_reader = data_reader

    def __len__(self) -> int:
        return self.data_reader.get_dataset_size(self.split)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.data_reader._squeeze(
            self.data_reader.get_batch(self.split, np.array([index]))
        )


class TrainDataset(_SplitDataset):
    split = "train"

    def train_neg_sample(self) -> None:
        """The reader's per-epoch negative sampling."""
        self.data_reader.train_neg_sample()


class DevDataset(_SplitDataset):
    split = "dev"


class TestDataset(_SplitDataset):
    split = "test"
