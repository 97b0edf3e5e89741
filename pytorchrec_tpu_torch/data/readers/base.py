"""Data reader base (port of ``pytorchrec_tpu/data/readers/base.py``): a
columnar in-memory store over numpy frames and fixed-shape batch slicing.

* A dataset's tables are numpy frames (``data/process/io.py``): dicts of
  arrays in column order, read without pandas. The split, negative and
  history artifacts are made at first use by the processing pipeline
  (``data/process``), under the JAX package's names.
* Each split is a dict of contiguous numpy arrays; ``get_batch`` slices
  whole batches with vectorized gathers, no per-row Python.
* Item features for candidate lists are ``lookup[iid]`` gathers over
  per-feature arrays indexed by iid.
* Per-epoch pair-wise negatives: ``neg_sample_mode="parity"`` keeps the JAX
  reader's generator stream (one vector draw, then scalar redraws of the
  conflicting rows in order), so the pairs are equal to its; ``"fast"``
  runs the native sampler (``native/fastrec.cpp``) with the JAX reader's
  seed, ``(random_seed << 20) + epoch``, and raises if the library cannot
  be built.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import numpy as np

from pytorchrec_tpu_torch import native
from pytorchrec_tpu_torch.data.process import (
    check_leave_k_out_split,
    check_sequential_split,
    check_vt_negative_sample,
    generate_leave_k_out_split,
    generate_sequential_split,
    generate_vt_negative_sample,
)
from pytorchrec_tpu_torch.data.process.io import Frame, frame_rows, read_frame
from pytorchrec_tpu_torch.data.process.vt_negative_sample import load_user_pos_his_set_dict
from pytorchrec_tpu_torch.data.schema import DatasetDescription, SplitMode, TrainMode
from pytorchrec_tpu_torch.feature_column import (
    CategoricalColumnWithIdentity,
    FeatureColumn,
    NumericColumn,
    NormalizationMode,
)
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)

Columns = Dict[str, np.ndarray]

TRAIN, DEV, TEST = "train", "dev", "test"


class DataReader:
    """Base reader: loads canonical artifacts, splits, serves columnar batches."""

    def __init__(
        self,
        dataset: str,
        split_mode: SplitMode = SplitMode.LEAVE_K_OUT,
        warm_n: int = 5,
        vt_ratio: float = 0.1,
        leave_k: int = 1,
        neg_sample_n: int = 99,
        load_feature: bool = False,
        append_id: bool = False,
        train_mode: TrainMode = TrainMode.POINT_WISE,
        random_seed: int = 2020,
        neg_sample_mode: str = "parity",  # "parity" (the JAX reader's stream) or "fast" (native)
        **kwargs,
    ):
        self.dataset = dataset
        # accept the enums' string values too ("pair_wise", "leave_k_out"):
        # a silently-ignored string train_mode would otherwise train
        # point-wise without any signal (found by an end-to-end drive)
        self.split_mode = (SplitMode(split_mode)
                           if isinstance(split_mode, str) else split_mode)
        self.warm_n = warm_n
        self.vt_ratio = vt_ratio
        self.leave_k = leave_k
        self.neg_sample_n = neg_sample_n
        self.load_feature = load_feature
        self.append_id = append_id
        self.train_mode = (TrainMode(train_mode)
                           if isinstance(train_mode, str) else train_mode)
        self.random_seed = random_seed
        self.neg_sample_mode = neg_sample_mode
        self._fast_epoch = 0
        self.rng = np.random.default_rng(random_seed)

        self.interaction_frame: Optional[Frame] = None
        self.item_frame: Optional[Frame] = None
        self.description: Optional[DatasetDescription] = None
        self.feature_column_dict: Dict[str, FeatureColumn] = {}

        # columnar splits
        self.splits: Dict[str, Columns] = {}
        # eval candidate arrays [rows, 1 + neg_sample_n] (leave-k-out only)
        self.iid_topk: Dict[str, np.ndarray] = {}
        # pairwise training state
        self.train_iid_pair_array: Optional[np.ndarray] = None
        self._pos_key_array: Optional[np.ndarray] = None
        self._user_pos_his_set_dict: Optional[Dict[int, set]] = None
        self.min_iid_array_index: Optional[int] = None
        self.max_iid_array_index: Optional[int] = None
        # item feature lookup arrays indexed by iid (row 0 = PAD)
        self._item_lookup: Dict[str, np.ndarray] = {}
        # auxiliary full-table arrays aligned with interaction rows (history,
        # next-state); sliced into every split alongside the interaction
        # columns
        self._aux_full: Dict[str, np.ndarray] = {}

        logger.info("loading dataset %s ...", dataset)
        self._load_dataset()
        logger.info("dataset %s loaded", dataset)

    # ------------------------------------------------------------------
    # loading pipeline (subclasses override _load_dataset to add stages)
    # ------------------------------------------------------------------

    def _load_dataset(self) -> None:
        self._load_interactions()
        self._create_feature_column_dict()
        self._load_items()
        self._split_interactions()
        if self.split_mode == SplitMode.LEAVE_K_OUT:
            self._load_neg_sample()
        if self.train_mode == TrainMode.PAIR_WISE:
            self._prepare_train_neg_sample()

    def _dataset_path(self, *parts: str) -> str:
        return os.path.join(C.dataset_dir(), self.dataset, *parts)

    def _load_interactions(self) -> None:
        name = C.INTERACTION_FRAME if self.load_feature else C.BASE_INTERACTION_FRAME
        self.interaction_frame = read_frame(self._dataset_path(name))
        try:
            self.description = DatasetDescription.load(self.dataset)
        except FileNotFoundError:
            self.description = None
        logger.info("interactions: %d rows", frame_rows(self.interaction_frame))

    def _numeric_feature_names(self) -> set:
        """Feature names typed numeric by the dataset description."""
        if self.description is None:
            return set()
        metas = (
            self.description.base_features
            + self.description.context_features
            + self.description.user_features
            + self.description.item_features
        )
        return {m.feature_name for m in metas if m.feature_type == C.NUMERIC_COLUMN}

    def _create_feature_column_dict(self) -> None:
        """One column object per interaction column, in the frame's order;
        numeric-typed features become ``NumericColumn`` (z-score) instead of
        categorical."""
        numeric = self._numeric_feature_names()
        for column, series in self.interaction_frame.items():
            if column in numeric:
                self.feature_column_dict[column] = NumericColumn.from_array(
                    column, series, NormalizationMode.Z_SCORE
                )
            else:
                self.feature_column_dict[column] = CategoricalColumnWithIdentity.from_series(
                    feature_name=column, series=series
                )

    def _load_items(self) -> None:
        self.item_frame = read_frame(self._dataset_path(C.ITEM_FRAME))
        if not self.load_feature:
            self.item_frame = {C.IID: self.item_frame[C.IID]}
        # lookup arrays indexed directly by iid (0 = PAD row of zeros)
        iids = self.item_frame[C.IID]
        size = int(iids.max()) + 1
        numeric = self._numeric_feature_names()
        for column, values in self.item_frame.items():
            lookup = np.zeros(size, dtype=values.dtype)
            lookup[iids] = values
            self._item_lookup[column] = lookup
            if column not in self.feature_column_dict:
                if column in numeric:
                    self.feature_column_dict[column] = NumericColumn.from_array(
                        column, values, NormalizationMode.Z_SCORE
                    )
                else:
                    self.feature_column_dict[column] = (
                        CategoricalColumnWithIdentity.from_series(column, values)
                    )
        logger.info("items: %d rows", frame_rows(self.item_frame))

    def _split_name(self) -> str:
        if self.split_mode == SplitMode.SEQUENTIAL_SPLIT:
            return C.SEQUENTIAL_SPLIT_NAME_TEMPLATE % (self.warm_n, self.vt_ratio)
        return C.LEAVE_K_OUT_SPLIT_NAME_TEMPLATE % (self.warm_n, self.leave_k)

    def _split_interactions(self) -> None:
        """Load (generating at first use) the split index arrays and slice
        the columnar splits."""
        if self.split_mode == SplitMode.SEQUENTIAL_SPLIT:
            if (self.warm_n, self.vt_ratio) not in check_sequential_split(self.dataset):
                generate_sequential_split(self.dataset, self.warm_n, self.vt_ratio)
        else:
            if (self.warm_n, self.leave_k) not in check_leave_k_out_split(self.dataset):
                generate_leave_k_out_split(self.dataset, self.warm_n, self.leave_k)

        split_dir = self._dataset_path(C.SPLIT_INDEX_DIR)
        split_name = self._split_name()
        for split, template in [
            (TRAIN, C.TRAIN_INDEX_NPY_TEMPLATE),
            (DEV, C.DEV_INDEX_NPY_TEMPLATE),
            (TEST, C.TEST_INDEX_NPY_TEMPLATE),
        ]:
            index = np.load(os.path.join(split_dir, template % split_name))
            self.splits[split] = self._take_rows(np.sort(index))
            logger.info("%s split: %d rows", split, len(index))

    def _take_rows(self, index: np.ndarray) -> Columns:
        """Interaction rows at ``index`` as a dict of contiguous arrays."""
        columns: Columns = {}
        for column, values in self.interaction_frame.items():
            columns[column] = np.ascontiguousarray(values[index])
        for name, array in self._aux_full.items():
            columns[name] = np.ascontiguousarray(array[index])
        return columns

    def _load_neg_sample(self) -> None:
        """Stack [pos, neg_1..neg_n] per dev/test row (the npy rows are keyed
        by ``uid - 1``)."""
        neg_dir = self._dataset_path(C.NEGATIVE_SAMPLE_DIR)
        self._maybe_generate_vt_negative_sample()
        user_index = self.splits[DEV][C.UID] - 1
        for split, template in [(DEV, C.DEV_NEG_NPY_TEMPLATE), (TEST, C.TEST_NEG_NPY_TEMPLATE)]:
            neg = np.load(
                os.path.join(neg_dir, template % (self.random_seed, self.neg_sample_n))
            )[user_index]
            pos = self.splits[split][C.IID].reshape(-1, 1)
            self.iid_topk[split] = np.hstack((pos.astype(neg.dtype), neg))
        assert self.iid_topk[DEV].shape[1] == self.iid_topk[TEST].shape[1]

    def _maybe_generate_vt_negative_sample(self) -> None:
        if self.random_seed not in check_vt_negative_sample(self.dataset):
            generate_vt_negative_sample(self.random_seed, self.dataset, self.neg_sample_n)

    def _prepare_train_neg_sample(self) -> None:
        """Drop train negatives, preload positive-set membership structures."""
        self.min_iid_array_index = 1  # 0 is PAD
        self.max_iid_array_index = int(self.item_frame[C.IID].max()) + 1

        train = self.splits[TRAIN]
        pos_mask = train[C.LABEL] == 1
        self.splits[TRAIN] = {k: v[pos_mask] for k, v in train.items()}
        logger.info("train positives: %d rows", int(pos_mask.sum()))

        self._user_pos_his_set_dict = load_user_pos_his_set_dict(self.dataset)
        # sorted (uid * K + iid) keys for the vectorized membership test
        K = self.max_iid_array_index
        keys = [
            np.int64(uid) * K + np.fromiter(s, dtype=np.int64, count=len(s))
            for uid, s in self._user_pos_his_set_dict.items()
            if s
        ]
        self._pos_key_array = np.sort(np.concatenate(keys)) if keys else np.empty(0, np.int64)

        pos = self.splits[TRAIN][C.IID].reshape(-1, 1)
        # neg column starts as a copy of pos (valid ids) so shape-bootstrap
        # batches fetched before the first train_neg_sample() are in-range;
        # every training epoch overwrites it
        self.train_iid_pair_array = np.hstack((pos, pos.copy()))

    # ------------------------------------------------------------------
    # reader interface
    # ------------------------------------------------------------------

    def train_neg_sample(self) -> None:
        """Per-epoch pair-wise negative sampling: the JAX reader's generator
        stream, conflicts found vectorized. ``neg_sample_mode="fast"`` runs
        the native sampler (``native/``): the same rejection semantics,
        another stream, seeded as the JAX reader seeds its own."""
        assert self.train_mode == TrainMode.PAIR_WISE
        n = len(self.splits[TRAIN][C.UID])
        lo, hi = self.min_iid_array_index, self.max_iid_array_index

        if self.neg_sample_mode == "fast":
            self._fast_epoch += 1
            self.train_iid_pair_array[:, 1] = native.neg_sample(
                self.splits[TRAIN][C.UID], lo, hi, self._pos_key_array,
                seed=(self.random_seed << 20) + self._fast_epoch,
            )
            return
        neg = self.rng.integers(low=lo, high=hi, size=n, dtype=np.int32)

        uids = self.splits[TRAIN][C.UID].astype(np.int64)
        keys = uids * hi + neg
        conflicts = np.flatnonzero(
            np.isin(keys, self._pos_key_array, assume_unique=False)
        )
        for index in conflicts:  # rare; redrawn in row order, as the JAX reader does
            inter_iid_set = self._user_pos_his_set_dict[int(uids[index])]
            while int(neg[index]) in inter_iid_set:
                neg[index] = self.rng.integers(low=lo, high=hi, dtype=np.int32)
        self.train_iid_pair_array[:, 1] = neg

    def get_feature_column_dict(self) -> Dict[str, FeatureColumn]:
        return self.feature_column_dict

    def get_train_dataset_size(self) -> int:
        return len(self.splits[TRAIN][C.UID])

    def get_dev_dataset_size(self) -> int:
        return len(self.splits[DEV][C.UID])

    def get_test_dataset_size(self) -> int:
        return len(self.splits[TEST][C.UID])

    def get_dataset_size(self, split: str) -> int:
        return len(self.splits[split][C.UID])

    # ------------------------------------------------------------------
    # columnar batch serving
    # ------------------------------------------------------------------

    def _candidate_iids(self, split: str) -> Optional[np.ndarray]:
        """Per-row candidate iid arrays, or None when rows are scalar-iid."""
        if split == TRAIN:
            if self.train_mode == TrainMode.PAIR_WISE:
                return self.train_iid_pair_array
            return None
        if self.split_mode == SplitMode.LEAVE_K_OUT:
            return self.iid_topk[split]
        return None

    def _join_items(self, batch: Dict[str, Any], iid_block: np.ndarray) -> None:
        """Overwrite item-feature columns (incl. IID) with candidate-shaped
        gathers."""
        for column, lookup in self._item_lookup.items():
            batch[column] = lookup[iid_block]

    def get_batch(self, split: str, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """Slice a batch: interaction columns + INDEX + candidate item join."""
        columns = self.splits[split]
        batch: Dict[str, np.ndarray] = {k: v[indices] for k, v in columns.items()}
        batch[C.INDEX] = np.asarray(indices)
        candidates = self._candidate_iids(split)
        if candidates is not None:
            self._join_items(batch, candidates[indices])
        else:
            # scalar-iid rows still get their item features (CTR models
            # need the join in every mode)
            self._join_items(batch, batch[C.IID])
        return batch

    def get_train_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return self.get_batch(TRAIN, indices)

    def get_dev_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return self.get_batch(DEV, indices)

    def get_test_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return self.get_batch(TEST, indices)

    # single-row access
    def get_train_dataset_item(self, index: int) -> Dict[str, Any]:
        return self._squeeze(self.get_batch(TRAIN, np.array([index])))

    def get_dev_dataset_item(self, index: int) -> Dict[str, Any]:
        return self._squeeze(self.get_batch(DEV, np.array([index])))

    def get_test_dataset_item(self, index: int) -> Dict[str, Any]:
        return self._squeeze(self.get_batch(TEST, np.array([index])))

    @staticmethod
    def _squeeze(batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        return {k: v[0] for k, v in batch.items()}
