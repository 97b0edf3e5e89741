"""The port's readers against the JAX package's (every case of
``tests/test_readers.py``, the RL reader's included), on the CPU.

Each package generates the same synthetic dataset in a work dir of its own
(its readers then make their own split, negative and history files there)
and builds the same reader; the two must hold equal columnar splits
(names, order, dtypes, values), dev/test candidates (``iid_topk``), feature
columns (names, order, ``category_num``, numeric statistics), batches, eval
batches with their padding, and three epochs of pair-wise negatives in the
parity mode (the JAX reader's generator stream) and the fast mode (the
native sampler, seeded alike). Last, a process where pandas and pyarrow
cannot be imported (as on the card's machine) generates data, builds each
reader and fits a step.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorchrec_tpu import data as jax_data
from pytorchrec_tpu import native as jax_native
from pytorchrec_tpu.data.process.datasets.synthetic import (
    generate_synthetic_ctr as jax_generate_ctr,
    generate_synthetic_ml as jax_generate_ml,
)
from pytorchrec_tpu_torch import data
from pytorchrec_tpu_torch.data import adapter
from pytorchrec_tpu_torch.data.process.history import pad_or_cut_array
from pytorchrec_tpu_torch.utils import constants as C
from torch_native_helpers import jax_native_dir, jax_native_private  # noqa: F401 (fixtures)

ROOT = Path(__file__).resolve().parents[1]
ML, CTR = "Synthetic-ML-Readers", "Synthetic-CTR-Readers"
ML_ARGS = dict(n_users=60, n_items=150, seed=7)
CTR_ARGS = dict(n_rows=1500, n_dense=3, sparse_vocab_sizes={"c_0": 60, "c_1": 9, "c_2": 400},
                seed=7)

# name: (reader class name, dataset, reader kwargs over the defaults)
CASES = {
    "simple_loo": ("SimpleDataReader", ML, {}),
    "simple_pair": ("SimpleDataReader", ML, dict(train_mode="pair_wise")),
    "simple_pair_fast": ("SimpleDataReader", ML, dict(train_mode="pair_wise",
                                                      neg_sample_mode="fast")),
    "simple_sequential": ("SimpleDataReader", ML, dict(split_mode="sequential_split")),
    "features_loo": ("SimpleDataReader", ML, dict(load_feature=True)),
    "history": ("HistoryDataReader", ML, dict(max_his_len=6, use_neg_his=True)),
    "history_pair_fast": ("HistoryDataReader", ML, dict(max_his_len=20, train_mode="pair_wise",
                                                        neg_sample_mode="fast",
                                                        neg_sample_n=49)),
    "svdpp": ("SVDPPDataReader", ML, dict(limit=12)),
    "svdpp_pair": ("SVDPPDataReader", ML, dict(limit=30, train_mode="pair_wise")),
    "value_rl": ("ValueRLDataReader", ML, dict(max_state_len=6, rl_sample_len=4)),
    "value_rl_neg_pair": ("ValueRLDataReader", ML, dict(max_state_len=5, use_neg_state=True,
                                                        rl_sample_len=5,
                                                        train_mode="pair_wise")),
    "ctr": ("CTRDataReader", CTR, dict(split_mode="sequential_split", warm_n=1)),
    "ctr_loo": ("CTRDataReader", CTR, dict(warm_n=2, neg_sample_n=9)),
}


def _defaults(package, **kwargs):
    defaults = dict(split_mode=package.SplitMode.LEAVE_K_OUT, warm_n=5, vt_ratio=0.1,
                    leave_k=1, neg_sample_n=19, load_feature=False, append_id=False,
                    train_mode=package.TrainMode.POINT_WISE, random_seed=2020)
    defaults.update(kwargs)
    return defaults


def _make(package, generate_ml, generate_ctr, case):
    cls, dataset, kwargs = CASES[case]
    if dataset == ML:
        generate_ml(ML, **ML_ARGS)
    else:
        generate_ctr(CTR, **CTR_ARGS)
    return getattr(package, cls)(dataset, **_defaults(package, **kwargs))


@pytest.fixture(params=list(CASES))
def readers(request, tmp_path, monkeypatch, jax_native_private):
    """(port reader, JAX reader) of one case, each from a work dir of its own
    (JAX's native library built in this process's own directory)."""
    built = {}
    for name, package, generate_ml, generate_ctr in (
            ("jax", jax_data, jax_generate_ml, jax_generate_ctr),
            ("port", data, data.generate_synthetic_ml, data.generate_synthetic_ctr)):
        monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(tmp_path / name))
        built[name] = _make(package, generate_ml, generate_ctr, request.param)
    return built["port"], built["jax"]


def _assert_columns_equal(got, want, label):
    assert list(got) == list(want), label
    for key, value in want.items():
        assert got[key].dtype == value.dtype, (label, key)
        np.testing.assert_array_equal(got[key], value, err_msg=f"{label} {key}")


def test_splits_candidates_and_feature_columns_match_jax(readers):
    port, jax = readers
    assert list(port.splits) == list(jax.splits) == ["train", "dev", "test"]
    for split in port.splits:
        _assert_columns_equal(port.splits[split], jax.splits[split], split)
        assert port.get_dataset_size(split) == jax.get_dataset_size(split) > 0
    assert port.get_train_dataset_size() == jax.get_train_dataset_size()
    assert port.get_dev_dataset_size() == jax.get_dev_dataset_size()
    assert port.get_test_dataset_size() == jax.get_test_dataset_size()
    _assert_columns_equal(port.iid_topk, jax.iid_topk, "iid_topk")
    _assert_columns_equal(port._item_lookup, jax._item_lookup, "item lookup")
    if port.split_mode == data.SplitMode.LEAVE_K_OUT:
        dev = port.get_dev_batch(np.arange(port.get_dev_dataset_size()))
        assert dev[C.IID].shape == (port.get_dev_dataset_size(), 1 + port.neg_sample_n)
        np.testing.assert_array_equal(dev[C.IID][:, 0], port.splits["dev"][C.IID])
    got, want = port.get_feature_column_dict(), jax.get_feature_column_dict()
    assert list(got) == list(want)
    for name, column in want.items():
        assert type(got[name]).__name__ == type(column).__name__, name
        for attr in ("category_num", "mean_value", "std_value", "min_value", "max_value"):
            assert getattr(got[name], attr, None) == getattr(column, attr, None), (name, attr)
        assert got[name]._info == column._info, name
    numeric = [n for n, c in got.items() if type(c).__name__ == "NumericColumn"]
    assert bool(numeric) == (port.dataset == CTR and port.load_feature)
    assert got[C.UID].category_num == int(port.interaction_frame[C.UID].max()) + 1


def test_batches_match_jax(readers):
    port, jax = readers
    for split in ("train", "dev", "test"):
        size = port.get_dataset_size(split)
        for indices in (np.arange(min(8, size)), np.random.default_rng(1).permutation(size)):
            _assert_columns_equal(port.get_batch(split, indices), jax.get_batch(split, indices),
                                  split)
        _assert_columns_equal(port._squeeze(port.get_batch(split, np.array([0]))),
                              jax._squeeze(jax.get_batch(split, np.array([0]))), split)
    for got, want in zip(data.train_batches(port, 16, np.random.default_rng(1)),
                         jax_data.train_batches(jax, 16, np.random.default_rng(1)), strict=True):
        _assert_columns_equal(got, want, "train_batches")
        assert got[C.UID].shape == (16,)
    total = 0
    for (got, valid), (want, want_valid) in zip(data.eval_batches(port, "dev", 16),
                                                jax_data.eval_batches(jax, "dev", 16),
                                                strict=True):
        assert valid == want_valid and got[C.UID].shape[0] == 16
        _assert_columns_equal(got, want, "eval_batches")
        total += valid
    assert total == port.get_dev_dataset_size()


def test_adapters_serve_rows(readers):
    port, jax = readers
    for cls in (adapter.TrainDataset, adapter.DevDataset, adapter.TestDataset):
        view = cls(port)
        assert len(view) == port.get_dataset_size(cls.split)
        _assert_columns_equal(view[len(view) - 1],
                              jax._squeeze(jax.get_batch(cls.split, np.array([len(view) - 1]))),
                              cls.split)


def test_three_epochs_of_negatives_match_jax(readers):
    port, jax = readers
    if port.train_mode != data.TrainMode.PAIR_WISE:
        assert port.train_iid_pair_array is None and jax.train_iid_pair_array is None
        return
    assert jax.neg_sample_mode != "fast" or jax_native.available()
    assert (port.splits["train"][C.LABEL] == 1).all()
    np.testing.assert_array_equal(port._pos_key_array, jax._pos_key_array)
    np.testing.assert_array_equal(port.train_iid_pair_array, jax.train_iid_pair_array)
    epochs = []
    for _ in range(3):
        port.train_neg_sample()
        jax.train_neg_sample()
        pairs = port.train_iid_pair_array
        np.testing.assert_array_equal(pairs, jax.train_iid_pair_array)
        assert pairs.shape == (port.get_train_dataset_size(), 2) and pairs.dtype == np.int32
        uids = port.splits["train"][C.UID]
        for i in range(len(uids)):
            assert int(pairs[i, 1]) not in port._user_pos_his_set_dict[int(uids[i])]
        batch = port.get_train_batch(np.arange(8))
        np.testing.assert_array_equal(batch[C.IID], pairs[:8])
        _assert_columns_equal(batch, jax.get_train_batch(np.arange(8)), "pair batch")
        epochs.append(pairs[:, 1].copy())
    assert not np.array_equal(epochs[0], epochs[1])
    if port.neg_sample_mode == "parity":  # the JAX reader's stream, from the seed
        rng = np.random.default_rng(2020)
        uids = port.splits["train"][C.UID]
        lo, hi = port.min_iid_array_index, port.max_iid_array_index
        neg = rng.integers(low=lo, high=hi, size=len(uids), dtype=np.int32)
        for index, uid in enumerate(uids):
            while neg[index] in port._user_pos_his_set_dict[int(uid)]:
                neg[index] = rng.integers(low=lo, high=hi, dtype=np.int32)
        np.testing.assert_array_equal(epochs[0], neg)


def test_history_and_svdpp_columns(readers):
    port, _ = readers
    batch = port.get_train_batch(np.arange(4))
    if isinstance(port, data.HistoryDataReader):
        assert batch[C.POS_HIS].shape == (4, port.max_his_len)
        assert (batch[C.POS_HIS_LEN] >= 1).all()
        assert (C.NEG_HIS in batch) == port.use_neg_his
    if isinstance(port, data.ValueRLDataReader):
        assert batch[C.POS_NEXT_STATE].shape == (4, port.max_next_state_len)
        assert batch[C.RL_SAMPLE].shape == (4, port.rl_sample_len)
        assert (C.NEG_NEXT_STATE in batch) == port.use_neg_next_state
    if isinstance(port, data.SVDPPDataReader) and port.train_mode == data.TrainMode.POINT_WISE:
        # the lookup holds the whole train split (pair-wise drops its negatives after)
        uid = int(batch[C.UID][0])
        train = port.splits["train"]
        np.testing.assert_array_equal(
            batch[C.IIDS][0], pad_or_cut_array(train[C.IID][train[C.UID] == uid], port.limit))
    if port.split_mode == data.SplitMode.SEQUENTIAL_SPLIT:
        assert port.get_dev_batch(np.arange(4))[C.IID].ndim == 1


def test_registry_and_modes():
    assert data.data_reader_name_list == ["ctr", "history", "simple", "svdpp", "value_rl"]
    assert data.get_data_reader_type("History") is data.HistoryDataReader
    assert data.READERS.get("simple") is data.SimpleDataReader is data.DataReader
    assert data.get_data_reader_type("value_rl") is data.ValueRLDataReader


NO_PANDAS = r"""
import sys
sys.modules["pandas"] = None
sys.modules["pyarrow"] = None
import numpy as np
import torch
from pytorchrec_tpu_torch import data
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer

data.generate_synthetic_ml("NoPandas", n_users=30, n_items=80, seed=1)
data.generate_synthetic_ctr("NoPandasCTR", n_rows=600, n_dense=2,
                            sparse_vocab_sizes={"c_0": 30, "c_1": 5}, seed=1)
readers = {
    "simple": data.SimpleDataReader("NoPandas", neg_sample_n=9, train_mode="pair_wise",
                                    neg_sample_mode="fast"),
    "history": data.HistoryDataReader("NoPandas", neg_sample_n=9, max_his_len=5),
    "svdpp": data.SVDPPDataReader("NoPandas", neg_sample_n=9, limit=8),
    "ctr": data.CTRDataReader("NoPandasCTR", split_mode="sequential_split", warm_n=1),
    "value_rl": data.ValueRLDataReader("NoPandas", neg_sample_n=9, max_state_len=5,
                                       use_neg_state=True, rl_sample_len=4),
}
readers["simple"].train_neg_sample()
columns = readers["ctr"].get_feature_column_dict()
model = DCNv2(sparse_columns=[columns["c_0"], columns["c_1"]],
              dense_columns=[columns["d_0"], columns["d_1"]], label_column=columns["label"],
              emb_size=4, num_cross_layers=1, layers=(8,), unified_embedding=True,
              device="cpu", generator=torch.Generator().manual_seed(0))
trainer = SparseEmbeddingTrainer(model, device="cpu", packed_tables=True)
trainer.compile(optimizer="adam", lr=1e-2, loss="bce", metrics=("auc",))
size = readers["ctr"].get_train_dataset_size()
history = trainer.fit(readers["ctr"], batch_size=size, epochs=1, verbose=0)
assert trainer.state.step == 1 and np.isfinite(history.history["loss"]).all(), history.history
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("pandas", "pyarrow", "jax", "pytorchrec_tpu"))
assert not loaded, loaded
print("ok", {name: r.get_train_dataset_size() for name, r in readers.items()})
"""


def test_readers_and_fit_need_no_pandas(tmp_path):
    env = {**os.environ, "PYTORCHREC_TPU_WORK_DIR": str(tmp_path)}
    run = subprocess.run([sys.executable, "-c", NO_PANDAS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("ok")
