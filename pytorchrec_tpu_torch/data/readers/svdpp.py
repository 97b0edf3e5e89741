"""SVD++ reader (port of ``pytorchrec_tpu/data/readers/svdpp.py``): a
per-user full train-history ``IIDS`` column.

Each user's implicit-feedback vector is their whole train-split item list,
padded or cut to ``limit``, served with every row: a ``[max_uid+1, limit]``
lookup gathered a batch.
"""

from __future__ import annotations

import numpy as np

from pytorchrec_tpu_torch.data.process.history import pad_or_cut_array
from pytorchrec_tpu_torch.data.readers.base import TRAIN, DataReader
from pytorchrec_tpu_torch.data.schema import SplitMode, TrainMode
from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.utils import constants as C


class SVDPPDataReader(DataReader):
    def __init__(self, *args, limit: int = 256, **kwargs):
        self.limit = limit
        self._uid_iids_lookup = None
        super().__init__(*args, **kwargs)

    def _load_dataset(self) -> None:
        self._load_interactions()
        self._create_feature_column_dict()
        self._load_items()
        self._split_interactions()
        self._create_user_all_history()
        if self.split_mode == SplitMode.LEAVE_K_OUT:
            self._load_neg_sample()
        if self.train_mode == TrainMode.PAIR_WISE:
            self._prepare_train_neg_sample()

    def _create_user_all_history(self) -> None:
        """[max_uid+1, limit] per-user train-item lists (row 0 = PAD user,
        all-zero)."""
        uids = self.splits[TRAIN][C.UID]
        iids = self.splits[TRAIN][C.IID]
        max_uid = int(self.interaction_frame[C.UID].max())
        lookup = np.zeros((max_uid + 1, self.limit), dtype=iids.dtype)
        order = np.argsort(uids, kind="stable")
        sorted_uids, sorted_iids = uids[order], iids[order]
        unique, starts, counts = np.unique(sorted_uids, return_index=True, return_counts=True)
        for uid, start, count in zip(unique, starts, counts):
            lookup[uid] = pad_or_cut_array(sorted_iids[start : start + count], self.limit)
        self._uid_iids_lookup = lookup
        self.feature_column_dict[C.IIDS] = CategoricalColumnWithIdentity(
            feature_name=C.IIDS, category_num=0
        )

    def get_batch(self, split: str, indices: np.ndarray):
        batch = super().get_batch(split, indices)
        batch[C.IIDS] = self._uid_iids_lookup[batch[C.UID]]
        return batch
