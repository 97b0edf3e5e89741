"""The port's processing pipeline against the JAX package's.

A dataset written by the JAX package (feather) is copied into a second
work dir and converted there with ``frames_from_feather``, so both packages
process the same rows, each in its own work dir: both split modes, the
dev/test negatives (and the positive-set pickle), the histories and the
next-state arrays give byte-equal ``.npy`` and ``.csv`` files and equal
``check_*`` lists. The native loops (``native/fastrec.cpp``): the history
against its numpy version and against the JAX package's, the negative
sampler against the JAX package's native sampler for the same seed.
"""

import os
import shutil

import numpy as np
import pytest

from pytorchrec_tpu import native as jax_native
from pytorchrec_tpu.data import process as jax_process
from pytorchrec_tpu.data.process.datasets.synthetic import (
    generate_synthetic_ctr as jax_generate_ctr,
    generate_synthetic_ml as jax_generate_ml,
)
from pytorchrec_tpu.data.process.history import _history_matrix as jax_history_numpy
from pytorchrec_tpu_torch import native
from pytorchrec_tpu_torch.data import process
from pytorchrec_tpu_torch.data.process.history import _history_matrix, history_matrix
from pytorchrec_tpu_torch.data.process.io import frames_from_feather
from pytorchrec_tpu_torch.data.process.vt_negative_sample import first_appearance
from pytorchrec_tpu_torch.utils import constants as C
from torch_native_helpers import jax_native_dir, jax_native_private  # noqa: F401 (fixtures)

DATASET = "Process"


@pytest.fixture(params=["ml", "ctr"])
def dirs(request, tmp_path, monkeypatch):
    """``use("jax" | "port")`` makes that package's work dir the current
    one; both hold the JAX package's dataset, the port's as frames."""
    paths = {name: tmp_path / name for name in ("jax", "port")}

    def use(name):
        monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(paths[name]))
        return os.path.join(paths[name], "Dataset", DATASET)

    use("jax")
    if request.param == "ml":
        jax_generate_ml(DATASET, n_users=50, n_items=160, seed=9, markov_strength=0.4,
                        n_clusters=5)
    else:  # CTR rows: many users with few rows, repeated items
        jax_generate_ctr(DATASET, n_rows=1500, n_dense=2,
                         sparse_vocab_sizes={"c_0": 300, "c_1": 9}, seed=9)
    shutil.copytree(paths["jax"] / "Dataset", paths["port"] / "Dataset")
    use("port")
    assert len(frames_from_feather(DATASET)) >= 3
    return use


def _files(directory):
    """Every file under ``directory`` but the frames, by relative path, as bytes."""
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            if not name.endswith(".npz"):
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, directory)] = f.read()
    return out


def _both(use, run):
    """``run(package's process module)`` in each work dir; the files each
    dataset dir holds afterwards, less the tables."""
    got = {}
    for name, module in (("jax", jax_process), ("port", process)):
        directory = use(name)
        run(module)
        got[name] = _files(directory)
    return got


def _assert_same_files(got, expected_dir):
    assert got["port"].keys() == got["jax"].keys()
    made = [k for k in got["jax"] if k.startswith(expected_dir)]
    assert made, expected_dir
    for key, value in got["jax"].items():
        assert got["port"][key] == value, key


@pytest.mark.parametrize("args", [(5, 0.1), (0, 0.2), (1, 0.25)])
def test_sequential_split_files_match_jax(dirs, args):
    got = _both(dirs, lambda m: m.generate_sequential_split(DATASET, *args))
    _assert_same_files(got, C.SPLIT_INDEX_DIR)
    assert any(k.endswith(".csv") for k in got["port"])
    for name, module in (("jax", jax_process), ("port", process)):
        dirs(name)
        assert module.check_sequential_split(DATASET) == [(max(args[0], 1), args[1])]


@pytest.mark.parametrize("args", [(5, 1), (3, 2), (0, 1)])
def test_leave_k_out_split_files_match_jax(dirs, args):
    got = _both(dirs, lambda m: m.generate_leave_k_out_split(DATASET, *args))
    _assert_same_files(got, C.SPLIT_INDEX_DIR)
    for name, module in (("jax", jax_process), ("port", process)):
        dirs(name)
        assert module.check_leave_k_out_split(DATASET) == [(max(args[0], 1), args[1])]


@pytest.mark.parametrize("parity", [True, False])
def test_vt_negative_sample_files_match_jax(dirs, parity):
    def run(module):
        module.generate_vt_negative_sample(2020, DATASET, 9, parity=parity)
        module.generate_vt_negative_sample(7, DATASET, 4, parity=parity)

    got = _both(dirs, run)
    _assert_same_files(got, C.NEGATIVE_SAMPLE_DIR)
    assert os.path.join(C.NEGATIVE_SAMPLE_DIR, C.USER_POS_HIS_SET_DICT_PKL) in got["port"]
    for name, module in (("jax", jax_process), ("port", process)):
        dirs(name)
        assert module.check_vt_negative_sample(DATASET) == [4, 9]


@pytest.mark.parametrize("k", [1, 5, 20])
def test_history_and_next_state_files_match_jax(dirs, k):
    def run(module):
        module.generate_interaction_history_list(DATASET, k)
        module.generate_interaction_next_state_list(DATASET, k)

    got = _both(dirs, run)
    _assert_same_files(got, C.HISTORY_DIR)
    _assert_same_files(got, C.NEXT_STATE_DIR)
    assert os.path.join(C.HISTORY_DIR, C.NEG_HIS_NPY_TEMPLATE % k) in got["port"]
    for name, module in (("jax", jax_process), ("port", process)):
        dirs(name)
        assert module.check_interaction_history_list(DATASET) == [k]
        assert module.check_interaction_next_state_list(DATASET) == [k]
        assert module.check_dataset_info() == [DATASET]


def test_first_appearance_is_pandas_unique():
    import pandas as pd

    values = np.random.default_rng(3).integers(0, 40, 500).astype(np.int32)
    got = first_appearance(values)
    want = pd.Series(values).unique()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.unique(values))


def _history_inputs(seed, n=4000):
    rng = np.random.default_rng(seed)
    uids = rng.integers(1, 70, size=n).astype(np.int32)  # users interleaved
    iids = rng.integers(1, 500, size=n).astype(np.int32)
    labels = rng.integers(0, 2, size=n).astype(np.int64)
    return uids, iids, labels > 0


@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("k", [1, 5, 10, 64])
def test_native_history_matches_numpy_and_jax(k, inclusive, jax_native_private):
    assert jax_native.available()
    uids, iids, events = _history_inputs(k + int(inclusive))
    got = history_matrix(uids, iids, events, k, inclusive)
    assert got.dtype == np.int32 and got.shape == (len(uids), k + 1)
    np.testing.assert_array_equal(got, _history_matrix(uids, iids, events, k, inclusive))
    np.testing.assert_array_equal(got, jax_history_numpy(uids, iids, events, k, inclusive))
    np.testing.assert_array_equal(got, jax_native.history_matrix(uids, iids, events, k,
                                                                 inclusive))


@pytest.mark.parametrize("seed", [0, 42, (2020 << 20) + 3])
def test_native_neg_sample_matches_jax(seed, jax_native_private):
    assert jax_native.available()
    rng = np.random.default_rng(1)
    n_users, hi = 40, 201
    uids = rng.integers(1, n_users + 1, size=3000).astype(np.int32)
    pos_keys = np.unique(uids.astype(np.int64) * hi + rng.integers(1, hi, size=3000))
    got = native.neg_sample(uids, 1, hi, pos_keys, seed=seed)
    np.testing.assert_array_equal(got, jax_native.neg_sample(uids, 1, hi, pos_keys, seed=seed))
    assert got.dtype == np.int32 and (got >= 1).all() and (got < hi).all()
    assert not np.isin(uids.astype(np.int64) * hi + got, pos_keys).any()


def test_native_library_is_named_by_its_source(tmp_path, monkeypatch):
    """The library's name carries a hash of the source and the flags, so an
    edited source builds anew; a source g++ refuses raises, with its output."""
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("fastrec_") and path == native.library_path()
    broken = tmp_path / "fastrec.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    assert native.library_path() != path
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "_build").iterdir())  # nothing half-written left
