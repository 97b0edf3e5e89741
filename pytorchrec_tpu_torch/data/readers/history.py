"""History reader (port of ``pytorchrec_tpu/data/readers/history.py``): adds
the positive (and optionally negative) behaviour-history columns.

The ``pos_his_%d.npy`` array's first column is the true length, clipped to
a minimum of 1 (the models depend on it), the rest the fixed-length padded
id sequence; the array is made at first use by the processing pipeline.
"""

from __future__ import annotations

import os

import numpy as np

from pytorchrec_tpu_torch.data.process import generate_interaction_history_list
from pytorchrec_tpu_torch.data.process.io import frame_rows
from pytorchrec_tpu_torch.data.readers.base import DataReader
from pytorchrec_tpu_torch.data.schema import SplitMode, TrainMode
from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.utils import constants as C


class HistoryDataReader(DataReader):
    def __init__(self, *args, max_his_len: int = 10, use_neg_his: bool = False, **kwargs):
        self.max_his_len = max_his_len
        self.use_neg_his = use_neg_his
        super().__init__(*args, **kwargs)

    def _load_dataset(self) -> None:
        self._load_interactions()
        self._create_feature_column_dict()
        self._load_history()
        self._load_items()
        self._split_interactions()
        if self.split_mode == SplitMode.LEAVE_K_OUT:
            self._load_neg_sample()
        if self.train_mode == TrainMode.PAIR_WISE:
            self._prepare_train_neg_sample()

    def _register_mixed_array(self, path_parts, len_name: str, seq_name: str,
                              generate) -> None:
        """Split a [N, 1+S] length-prefixed npy into len/seq aux columns."""
        path = self._dataset_path(*path_parts)
        if not os.path.exists(path):
            generate()
        mixed = np.load(path)
        assert mixed.shape[0] == frame_rows(self.interaction_frame), (path, mixed.shape)
        self._aux_full[len_name] = mixed[:, 0].clip(min=1)
        self._aux_full[seq_name] = mixed[:, 1:]
        self.feature_column_dict[len_name] = CategoricalColumnWithIdentity(
            feature_name=len_name, category_num=0
        )
        self.feature_column_dict[seq_name] = CategoricalColumnWithIdentity(
            feature_name=seq_name, category_num=0
        )

    def _load_history(self) -> None:
        gen = lambda: generate_interaction_history_list(self.dataset, self.max_his_len)
        self._register_mixed_array(
            (C.HISTORY_DIR, C.POS_HIS_NPY_TEMPLATE % self.max_his_len),
            C.POS_HIS_LEN, C.POS_HIS, gen,
        )
        if self.use_neg_his:
            self._register_mixed_array(
                (C.HISTORY_DIR, C.NEG_HIS_NPY_TEMPLATE % self.max_his_len),
                C.NEG_HIS_LEN, C.NEG_HIS, gen,
            )
