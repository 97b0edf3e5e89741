"""Global constants (port of ``pytorchrec_tpu/utils/constants.py``): the
artifact layout and the canonical column-name vocabulary.

The work dir comes from the ``PYTORCHREC_TPU_WORK_DIR`` environment
variable, read at each call, and defaults to ``./workdir`` under the
current working directory, so tests and CI are hermetic. The dataset
artifacts (dataset dir, split indices, negative samples, history,
next-state and RL-sample arrays) keep the JAX package's names, so both
packages find each other's files.
"""

from __future__ import annotations

import os

# ---------------------------------------------------------------------------
# Work dir layout
# ---------------------------------------------------------------------------


def work_dir() -> str:
    """Root directory for all datasets / logs / models / results."""
    return os.environ.get("PYTORCHREC_TPU_WORK_DIR", os.path.join(os.getcwd(), "workdir"))


def raw_data_dir() -> str:
    return os.path.join(work_dir(), "RawData")


def dataset_dir() -> str:
    return os.path.join(work_dir(), "Dataset")


def log_dir() -> str:
    return os.path.join(work_dir(), "Log")


def model_dir() -> str:
    return os.path.join(work_dir(), "Model")


def grid_search_dir() -> str:
    return os.path.join(work_dir(), "GridSearch")


def repeat_task_dir() -> str:
    return os.path.join(work_dir(), "RepeatTask")


def checkpoint_dir() -> str:
    return os.path.join(work_dir(), "Checkpoint")


# ---------------------------------------------------------------------------
# Dataset artifact filenames
# ---------------------------------------------------------------------------

BASE_INTERACTION_CSV = "base_interaction.csv"
BASE_INTERACTION_FEATHER = "base_interaction.feather"
INTERACTION_CSV = "interaction.csv"
INTERACTION_FEATHER = "interaction.feather"
ITEM_CSV = "item.csv"
ITEM_FEATHER = "item.feather"
USER_CSV = "user.csv"
USER_FEATHER = "user.feather"
DESCRIPTION_TXT = "description.txt"
DESCRIPTION_JSON = "description.json"

SPLIT_INDEX_DIR = "SPLIT_INDEX"

SEQUENTIAL_SPLIT_NAME_TEMPLATE = "seq_split_%d_%.2f"  # warm_n, vt_ratio
LEAVE_K_OUT_SPLIT_NAME_TEMPLATE = "leave_k_out_%d_%d"  # warm_n, k

TRAIN_INDEX_NPY_TEMPLATE = "%s.train_index.npy"
DEV_INDEX_NPY_TEMPLATE = "%s.dev_index.npy"
TEST_INDEX_NPY_TEMPLATE = "%s.test_index.npy"

NEGATIVE_SAMPLE_DIR = "NEGATIVE_SAMPLE"

USER_POS_HIS_SET_DICT_PKL = "user_pos_his_set_dict.pkl"
DEV_NEG_NPY_TEMPLATE = "dev_neg_%d_%d.npy"  # seed, sample_n
TEST_NEG_NPY_TEMPLATE = "test_neg_%d_%d.npy"  # seed, sample_n

HISTORY_DIR = "HISTORY"

POS_HIS_NPY_TEMPLATE = "pos_his_%d.npy"
NEG_HIS_NPY_TEMPLATE = "neg_his_%d.npy"

NEXT_STATE_DIR = "NEXT_STATE"

POS_NEXT_STATE_NPY_TEMPLATE = "pos_next_state_%d.npy"
NEG_NEXT_STATE_NPY_TEMPLATE = "neg_next_state_%d.npy"

RL_SAMPLE_DIR = "RL_SAMPLE"

RL_SAMPLE_NPY_TEMPLATE = "rl_sample_%d.npy"

SEP = "\t"
SEQ_SEP = ","

# ---------------------------------------------------------------------------
# Canonical column names
# ---------------------------------------------------------------------------

INDEX = "index"
UID = "uid"
IID = "iid"
RATE = "rate"
LABEL = "label"
TIME = "time"
IIDS = "iids"
POS_HIS_LEN = "pos_his_len"
POS_HIS = "pos_his"
NEG_HIS_LEN = "neg_his_len"
NEG_HIS = "neg_his"
POS_STATE_LEN = POS_HIS_LEN
POS_STATE = POS_HIS
NEG_STATE_LEN = NEG_HIS_LEN
NEG_STATE = NEG_HIS
POS_NEXT_STATE_LEN = "pos_next_state_len"
POS_NEXT_STATE = "pos_next_state"
NEG_NEXT_STATE_LEN = "neg_next_state_len"
NEG_NEXT_STATE = "neg_next_state"
RL_SAMPLE = "rl_sample"
REWARD = RATE  # RL reward defaults to the rating column

# ---------------------------------------------------------------------------
# Dataset description dictionary keys
# ---------------------------------------------------------------------------

INFO = "info"

BASE_FEATURES = "base_features"
CONTEXT_FEATURES = "context_features"
USER_FEATURES = "user_features"
ITEM_FEATURES = "item_features"

FEATURE_NAME = "feature_name"
FEATURE_TYPE = "feature_type"

NUMERIC_COLUMN = "numeric"
CATEGORICAL_COLUMN = "categorical"
NUMERIC_LIST_COLUMN = "numeric_list"
CATEGORICAL_LIST_COLUMN = "categorical_list"

BUCKET_BOUNDARIES = "bucket_boundaries"
BUCKET_LOG_BASE = "bucket_log_base"
INT_MAP = "int_map"

USER_INTERACTION = "user_interaction"

POSITIVE = "positive"
NEGATIVE = "negative"
ALL = "all"
MIN = "min"
MAX = "max"
MEAN = "mean"
MEDIAN = "median"
STD = "std"
