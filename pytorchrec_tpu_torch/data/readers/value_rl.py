"""Value-RL reader (port of ``pytorchrec_tpu/data/readers/value_rl.py``):
the history reader plus the RL next states ``s'`` (the state *including*
the current interaction) and each row's candidate action set
``rl_sample_<n>.npy``.

``max_state_len`` is the history's and the next state's length,
``use_neg_state`` adds the negative streams of both, ``rl_sample_len`` the
candidates a row. The arrays are made at first use by the processing
pipeline (``data/process``), under the JAX package's file names and bytes.
"""

from __future__ import annotations

import os

import numpy as np

from pytorchrec_tpu_torch.data.process import (
    generate_interaction_next_state_list,
    generate_rl_next_item_sample,
)
from pytorchrec_tpu_torch.data.process.io import frame_rows
from pytorchrec_tpu_torch.data.readers.history import HistoryDataReader
from pytorchrec_tpu_torch.data.schema import SplitMode, TrainMode
from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.utils import constants as C


class ValueRLDataReader(HistoryDataReader):
    def __init__(self, *args, max_state_len: int = 10, use_neg_state: bool = False,
                 rl_sample_len: int = 8, **kwargs):
        self.max_next_state_len = max_state_len
        self.use_neg_next_state = use_neg_state
        self.rl_sample_len = rl_sample_len
        super().__init__(*args, max_his_len=max_state_len, use_neg_his=use_neg_state, **kwargs)

    def _load_dataset(self) -> None:
        self._load_interactions()
        self._create_feature_column_dict()
        self._load_history()
        self._load_next_state()
        self._load_next_item_sample()
        self._load_items()
        self._split_interactions()
        if self.split_mode == SplitMode.LEAVE_K_OUT:
            self._load_neg_sample()
        if self.train_mode == TrainMode.PAIR_WISE:
            self._prepare_train_neg_sample()

    def _load_next_state(self) -> None:
        gen = lambda: generate_interaction_next_state_list(self.dataset,  # noqa: E731
                                                           self.max_next_state_len)
        self._register_mixed_array(
            (C.NEXT_STATE_DIR, C.POS_NEXT_STATE_NPY_TEMPLATE % self.max_next_state_len),
            C.POS_NEXT_STATE_LEN, C.POS_NEXT_STATE, gen,
        )
        if self.use_neg_next_state:
            self._register_mixed_array(
                (C.NEXT_STATE_DIR, C.NEG_NEXT_STATE_NPY_TEMPLATE % self.max_next_state_len),
                C.NEG_NEXT_STATE_LEN, C.NEG_NEXT_STATE, gen,
            )

    def _load_next_item_sample(self) -> None:
        path = self._dataset_path(C.RL_SAMPLE_DIR, C.RL_SAMPLE_NPY_TEMPLATE % self.rl_sample_len)
        if not os.path.exists(path):
            generate_rl_next_item_sample(self.dataset, self.rl_sample_len)
        rl_sample = np.load(path)
        assert rl_sample.shape[0] == frame_rows(self.interaction_frame), (path, rl_sample.shape)
        self._aux_full[C.RL_SAMPLE] = rl_sample
        self.feature_column_dict[C.RL_SAMPLE] = CategoricalColumnWithIdentity(
            feature_name=C.RL_SAMPLE, category_num=0
        )
