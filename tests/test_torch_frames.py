"""The port's on-disk tables: numpy ``.npz`` frames (``data/process/io.py``).

A frame keeps its columns' order and dtypes exactly, refuses an ``object``
column, and ``frames_from_feather`` turns the JAX package's feather tables
into frames that hold what ``pd.read_feather`` reads: the same columns in
the same order, the same dtypes and values. Each package writes in a work
dir of its own.
"""

import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest

from pytorchrec_tpu.data.process.datasets.synthetic import (
    generate_synthetic_ctr as jax_generate_ctr,
    generate_synthetic_ml as jax_generate_ml,
)
from pytorchrec_tpu_torch.data.process.io import (
    COLUMNS_KEY,
    FEATHER_FRAMES,
    frame_rows,
    frames_from_feather,
    read_frame,
    read_interactions,
    read_items,
    write_frame,
    write_tsv,
)
from pytorchrec_tpu_torch.utils import constants as C


@pytest.fixture()
def workdirs(tmp_path, monkeypatch):
    """``use(name)``: a work dir of that name, made the current one."""

    def use(name):
        path = tmp_path / name
        path.mkdir(exist_ok=True)
        monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(path))
        return path

    return use


def _columns():
    rng = np.random.default_rng(0)
    return {"uid": rng.integers(1, 9, 50).astype(np.int32),
            "time": np.arange(50, dtype=np.int32),
            "d_0": rng.lognormal(size=50).astype(np.float32),
            "c_0": rng.integers(0, 10**6, 50).astype(np.int64),
            "label": rng.integers(0, 2, 50).astype(np.int32),
            "pos_his": rng.integers(0, 30, (50, 4)).astype(np.int32),
            "flag": rng.random(50) < 0.5,
            "file": np.linspace(0.0, 1.0, 50)}  # np.savez's own argument name


def test_round_trip_keeps_order_dtypes_and_values(tmp_path):
    columns = _columns()
    path = str(tmp_path / "t.npz")
    write_frame(path, columns)
    got = read_frame(path)
    assert list(got) == list(columns)
    for name, values in columns.items():
        assert got[name].dtype == values.dtype, name
        np.testing.assert_array_equal(got[name], values, err_msg=name)
    assert frame_rows(got) == 50
    # the written order is the order read back, whatever it is
    reordered = dict(reversed(list(columns.items())))
    write_frame(path, reordered)
    assert list(read_frame(path)) == list(reordered)
    with np.load(path) as archive:  # np.savez's layout: one member an array
        assert archive[COLUMNS_KEY].tolist() == list(reordered)
        np.testing.assert_array_equal(archive["uid"], columns["uid"])


def test_refuses_object_columns_and_ragged_lengths(tmp_path):
    path = str(tmp_path / "t.npz")
    with pytest.raises(TypeError, match="object"):
        write_frame(path, {"uid": np.arange(3), "seq": np.array([[1], [1, 2], []],
                                                                dtype=object)})
    with pytest.raises(ValueError, match="lengths"):
        write_frame(path, {"uid": np.arange(3), "iid": np.arange(4)})
    with pytest.raises(ValueError):
        write_frame(path, {COLUMNS_KEY: np.arange(3)})
    assert not list(tmp_path.iterdir())  # nothing left behind


def _feather_tables(dataset):
    """The JAX package's tables of ``dataset`` as ``pd.read_feather`` reads them."""
    paths = {frame: os.path.join(C.dataset_dir(), dataset, feather)
             for feather, frame in FEATHER_FRAMES}
    return {frame: pd.read_feather(path) for frame, path in paths.items()
            if os.path.exists(path)}


@pytest.mark.parametrize("kind", ["ml", "ctr"])
def test_frames_from_feather_hold_what_pandas_reads(workdirs, kind):
    jax_dir = workdirs("jax")
    if kind == "ml":
        jax_generate_ml("FromFeather", n_users=30, n_items=80, seed=3, markov_strength=0.5,
                        n_clusters=4)
    else:
        jax_generate_ctr("FromFeather", n_rows=600, n_dense=3,
                         sparse_vocab_sizes={"c_0": 40, "c_1": 7, "c_2": 1000}, seed=3,
                         with_conversion=True)
    want = _feather_tables("FromFeather")
    port_dir = workdirs("port")
    shutil.copytree(jax_dir / "Dataset", port_dir / "Dataset")
    written = frames_from_feather("FromFeather")
    assert len(written) == len(want) == (4 if kind == "ml" else 3)
    for name, table in want.items():
        got = read_frame(f"{C.dataset_dir()}/FromFeather/{name}")
        assert list(got) == list(table.columns), name
        for column in table.columns:
            assert got[column].dtype == table[column].dtype, (name, column)
            np.testing.assert_array_equal(got[column], table[column].to_numpy(),
                                          err_msg=f"{name} {column}")
    frame = read_interactions("FromFeather")
    assert list(frame) == [C.UID, C.IID, C.RATE, C.LABEL, C.TIME]
    assert list(read_interactions("FromFeather", with_features=True)) == \
        list(want[C.INTERACTION_FRAME].columns)
    assert C.IID in read_items("FromFeather")


def test_frames_from_feather_names_pyarrow_where_it_is_absent(workdirs, monkeypatch):
    workdirs("port")
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="pyarrow"):
        frames_from_feather("Anything")


@pytest.mark.parametrize("shape,low,high", [((5000, 21), 0, 4000), ((3000,), -2**31, 2**31),
                                            ((2, 12), -12, 12), ((70000, 3), 0, 70000),
                                            ((0,), 0, 1), ((0, 4), 0, 1), ((1, 1), 7, 8)])
def test_index_csv_twins_are_savetxt_bytes(tmp_path, shape, low, high):
    """The ``.csv`` twin of an index artifact is ``np.savetxt``'s text (tab
    between numbers, a row a line), formatted a block at a time."""
    array = np.random.default_rng(len(shape) + high).integers(low, high, shape).astype(np.int32)
    if array.size:
        array.flat[0], array.flat[-1] = low, high - 1  # the extremes of the range
    np.savetxt(tmp_path / "want.csv", array, delimiter="\t", fmt="%d")
    write_tsv(str(tmp_path / "got.csv"), array)
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()
