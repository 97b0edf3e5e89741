"""The value-RL data path of the port against the JAX package's, on the CPU:
the candidate action sets (``data/process/rl_sample.py``) and the
``value_rl`` reader's next-state and candidate columns.

Each package generates the synthetic MovieLens-like set of
``tests/test_trainer.py`` (50 users, 120 items, seed 11) into a work dir of
its own and writes ``RL_SAMPLE/rl_sample_<n>.npy`` and its ``.csv`` twin:
the files must be byte-equal. The port gathers every row's window at once
where the JAX function walks the rows; edge cases (users with no positive,
with one, labels ending on a positive, sample lengths odd and even) go
through both on the same in-memory interactions. The reader's splits and
batches are held to JAX's by ``tests/test_torch_readers.py``'s RL cases.
"""

import numpy as np
import pandas as pd
import pytest

from pytorchrec_tpu import data as jax_data
from pytorchrec_tpu.data.process import rl_sample as jax_rl_sample
from pytorchrec_tpu.data.process.datasets.synthetic import generate_synthetic_ml as jax_generate_ml
from pytorchrec_tpu_torch import data
from pytorchrec_tpu_torch.data.process import (
    check_rl_next_item_sample,
    generate_rl_next_item_sample,
)
from pytorchrec_tpu_torch.data.process import rl_sample as port_rl_sample
from pytorchrec_tpu_torch.utils import constants as C

DATASET = "Synthetic-ML-RL-Data"
ML_ARGS = dict(n_users=50, n_items=120, seed=11)
WORK_DIR = "PYTORCHREC_TPU_WORK_DIR"


@pytest.fixture(scope="module")
def work_dirs(tmp_path_factory):
    """The dataset generated by each package into its own work dir."""
    root = tmp_path_factory.mktemp("rl_data")
    with pytest.MonkeyPatch.context() as mp:
        for tag, generate in (("jax", jax_generate_ml), ("port", data.generate_synthetic_ml)):
            mp.setenv(WORK_DIR, str(root / tag))
            generate(DATASET, **ML_ARGS)
    return {tag: root / tag for tag in ("jax", "port")}


@pytest.mark.parametrize("sample_len", [2, 3, 4, 8, 9])
def test_rl_sample_files_are_jax_bytes(work_dirs, monkeypatch, sample_len):
    monkeypatch.setenv(WORK_DIR, str(work_dirs["jax"]))
    jax_rl_sample.generate_rl_next_item_sample(DATASET, sample_len)
    monkeypatch.setenv(WORK_DIR, str(work_dirs["port"]))
    generate_rl_next_item_sample(DATASET, sample_len)
    assert sample_len in check_rl_next_item_sample(DATASET)
    for suffix in (".npy", ".csv"):
        name = (C.RL_SAMPLE_NPY_TEMPLATE % sample_len).replace(".npy", suffix)
        got = (work_dirs["port"] / "Dataset" / DATASET / C.RL_SAMPLE_DIR / name).read_bytes()
        want = (work_dirs["jax"] / "Dataset" / DATASET / C.RL_SAMPLE_DIR / name).read_bytes()
        assert got == want, name
    array = np.load(work_dirs["port"] / "Dataset" / DATASET / C.RL_SAMPLE_DIR /
                    (C.RL_SAMPLE_NPY_TEMPLATE % sample_len))
    assert array.dtype == np.int32 and array.shape[1] == sample_len


def test_check_lists_no_sample_before_one_is_made(tmp_path, monkeypatch):
    monkeypatch.setenv(WORK_DIR, str(tmp_path))
    assert check_rl_next_item_sample("Nothing") == []


def _jax_sample(monkeypatch, tmp_path, uids, iids, labels, sample_len):
    """JAX's generator over in-memory interactions (its reader patched)."""
    frame = pd.DataFrame({C.UID: uids, C.IID: iids, C.LABEL: labels})
    monkeypatch.setenv(WORK_DIR, str(tmp_path))
    monkeypatch.setattr(jax_rl_sample, "read_interactions", lambda name: frame)
    jax_rl_sample.generate_rl_next_item_sample("Edge", sample_len)
    name = C.RL_SAMPLE_NPY_TEMPLATE % sample_len
    return np.load(tmp_path / "Dataset" / "Edge" / C.RL_SAMPLE_DIR / name)


@pytest.mark.parametrize("seed", range(4))
def test_rl_sample_edge_cases_match_jax(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(seed)
    rows = 300
    uids = rng.integers(0, 25, rows)
    iids = rng.integers(1, 40, rows)
    labels = (rng.random(rows) < 0.4).astype(np.int64)
    labels[uids == 3] = 0  # a user with no positive: the history [0]
    single = np.nonzero(uids == 4)[0]
    labels[single] = 0
    if len(single):
        labels[single[-1]] = 1  # a user whose one positive is its last row
    for sample_len in (2, 3, 5, 6):
        want = _jax_sample(monkeypatch, tmp_path / str(sample_len), uids, iids, labels,
                           sample_len)
        got = port_rl_sample.rl_next_item_sample(uids, iids, labels, sample_len)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"sample_len {sample_len}")


def test_reader_registers_the_rl_columns(work_dirs, monkeypatch):
    monkeypatch.setenv(WORK_DIR, str(work_dirs["port"]))
    reader = data.get_data_reader_type("value_rl")(
        DATASET, neg_sample_n=9, max_state_len=5, use_neg_state=True, rl_sample_len=4)
    assert isinstance(reader, data.ValueRLDataReader)
    columns = reader.get_feature_column_dict()
    for name in (C.POS_STATE, C.POS_STATE_LEN, C.POS_NEXT_STATE, C.POS_NEXT_STATE_LEN,
                 C.NEG_STATE, C.NEG_NEXT_STATE, C.NEG_NEXT_STATE_LEN, C.RL_SAMPLE):
        assert columns[name].category_num == 0, name
    batch = reader.get_batch("train", np.arange(6))
    assert batch[C.RL_SAMPLE].shape == (6, 4) and batch[C.POS_NEXT_STATE].shape == (6, 5)
    assert (batch[C.POS_NEXT_STATE_LEN] >= 1).all()
    monkeypatch.setenv(WORK_DIR, str(work_dirs["jax"]))
    jax_reader = jax_data.ValueRLDataReader(
        DATASET, neg_sample_n=9, max_state_len=5, use_neg_state=True, rl_sample_len=4)
    for key, value in jax_reader.get_batch("train", np.arange(6)).items():
        np.testing.assert_array_equal(batch[key], value, err_msg=key)
        assert batch[key].dtype == value.dtype, key
