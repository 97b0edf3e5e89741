"""The port's synthetic generators against the JAX package's.

For the same arguments and seed, each package in a work dir of its own:
the port's frames hold the columns of the JAX package's feather tables
(``pd.read_feather``) in the same order, with the same dtypes and values,
and the two ``description.json`` and ``description.txt`` files are equal
byte for byte.
"""

import os

import numpy as np
import pandas as pd
import pytest

from pytorchrec_tpu.data.process.datasets.synthetic import (
    generate_synthetic_ctr as jax_generate_ctr,
    generate_synthetic_ml as jax_generate_ml,
)
from pytorchrec_tpu_torch.data import generate_synthetic_ctr, generate_synthetic_ml
from pytorchrec_tpu_torch.data.process.io import FEATHER_FRAMES, read_frame
from pytorchrec_tpu_torch.utils import constants as C

ML_CASES = {
    "plain": dict(n_users=60, n_items=150, seed=7),
    "sequential": dict(n_users=40, n_items=120, seed=11, sequential_strength=0.7),
    "markov": dict(n_users=50, n_items=300, seed=5, markov_strength=0.8, n_clusters=10),
    "both": dict(n_users=30, n_items=90, seed=2020, min_interactions=5, max_interactions=40,
                 markov_strength=0.5, sequential_strength=0.3, n_clusters=6,
                 positive_rate_threshold=3),
}
CTR_CASES = {
    "default_fields": dict(n_rows=3000, seed=3),
    "conversion": dict(n_rows=2000, n_dense=2, sparse_vocab_sizes={"c_0": 50, "c_1": 20},
                       seed=17, with_conversion=True),
    "wide": dict(n_rows=4096, n_dense=13, seed=2020, with_conversion=True,
                 sparse_vocab_sizes={f"c_{i}": 1000 for i in range(26)}),
}


def _in(tmp_path, monkeypatch, name):
    path = tmp_path / name
    path.mkdir()
    monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(path))
    return os.path.join(path, "Dataset", "Synthetic")


def _assert_same_dataset(jax_dir, port_dir, tables):
    for feather_name, frame_name in FEATHER_FRAMES:
        feather_path = os.path.join(jax_dir, feather_name)
        frame_path = os.path.join(port_dir, frame_name)
        assert os.path.exists(feather_path) == os.path.exists(frame_path), frame_name
        if not os.path.exists(feather_path):
            continue
        want = pd.read_feather(feather_path)
        got = read_frame(frame_path)
        assert list(got) == list(want.columns), frame_name
        for column in want.columns:
            assert got[column].dtype == want[column].dtype, (frame_name, column)
            np.testing.assert_array_equal(got[column], want[column].to_numpy(),
                                          err_msg=f"{frame_name} {column}")
        tables.append(frame_name)
    for name in (C.DESCRIPTION_JSON, C.DESCRIPTION_TXT):
        with open(os.path.join(jax_dir, name), "rb") as f_jax, \
                open(os.path.join(port_dir, name), "rb") as f_port:
            assert f_port.read() == f_jax.read(), name


@pytest.mark.parametrize("case", list(ML_CASES))
def test_synthetic_ml_matches_jax(tmp_path, monkeypatch, case):
    kwargs = ML_CASES[case]
    jax_dir = _in(tmp_path, monkeypatch, "jax")
    assert jax_generate_ml("Synthetic", **kwargs) == jax_dir
    port_dir = _in(tmp_path, monkeypatch, "port")
    assert generate_synthetic_ml("Synthetic", **kwargs) == port_dir
    tables = []
    _assert_same_dataset(jax_dir, port_dir, tables)
    assert tables == [C.BASE_INTERACTION_FRAME, C.INTERACTION_FRAME, C.ITEM_FRAME, C.USER_FRAME]
    frames = {name: read_frame(os.path.join(port_dir, name)) for name in tables}
    # two orders of the same columns: the reader's fields follow each
    assert list(frames[C.BASE_INTERACTION_FRAME]) == [C.UID, C.IID, C.RATE, C.LABEL, C.TIME]
    assert list(frames[C.INTERACTION_FRAME]) == [C.UID, C.IID, C.RATE, C.TIME, C.LABEL]
    assert all(v.dtype == np.int32 for v in frames[C.INTERACTION_FRAME].values())


@pytest.mark.parametrize("case", list(CTR_CASES))
def test_synthetic_ctr_matches_jax(tmp_path, monkeypatch, case):
    kwargs = CTR_CASES[case]
    jax_dir = _in(tmp_path, monkeypatch, "jax")
    jax_generate_ctr("Synthetic", **kwargs)
    port_dir = _in(tmp_path, monkeypatch, "port")
    assert generate_synthetic_ctr("Synthetic", **kwargs) == port_dir
    tables = []
    _assert_same_dataset(jax_dir, port_dir, tables)
    assert tables == [C.BASE_INTERACTION_FRAME, C.INTERACTION_FRAME, C.ITEM_FRAME]
    frame = read_frame(os.path.join(port_dir, C.INTERACTION_FRAME))
    sparse = [c for c in frame if c.startswith("c_")]
    assert {frame[c].dtype for c in sparse} == {np.dtype(np.int64)}
    assert {frame[c].dtype for c in frame if c.startswith("d_")} == {np.dtype(np.float32)}
    assert frame[C.LABEL].dtype == np.int32
    assert ("conversion" in frame) == kwargs.get("with_conversion", False)
    # rows in (uid, time) order
    order = np.lexsort((frame[C.TIME], frame[C.UID]))
    np.testing.assert_array_equal(order, np.arange(len(order)))
