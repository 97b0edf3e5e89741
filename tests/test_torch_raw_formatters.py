"""The port's raw formatters against the JAX package's.

The raw files of ``tests/test_raw_formatters.py`` (MovieLens 100K, 1M and
10M, Amazon review JSON, Jester, the three XING TSVs) and variants of them
(an interaction whose user or item has no features, so a merged int column
turns float; ages that sort differently as text; an item with no date),
plus a Criteo TSV with pandas' missing-value strings, short lines, blank
lines, negative and fractional dense values and text, are written into a
work dir a package. Each package formats them in its own work dir. Exact
comparisons (no tolerance): every port frame holds the columns of the JAX
package's feather table (``frames_from_feather``'s reading: ``pd.read_feather``
here) in the same order with the same dtypes and values; the Criteo shards
equal JAX's parquet shards read with pandas; the ``.csv`` tables and both
description files are equal byte for byte.
"""

import glob
import json
import os

import numpy as np
import pandas as pd
import pytest

from pytorchrec_tpu.data.process import datasets as jax_datasets
from pytorchrec_tpu_torch.data.process import datasets as port_datasets
from pytorchrec_tpu_torch.data.process.io import FEATHER_FRAMES, read_frame
from pytorchrec_tpu_torch.utils import constants as C

CSV_TABLES = (C.BASE_INTERACTION_CSV, C.INTERACTION_CSV, C.ITEM_CSV, C.USER_CSV)


def _work(tmp_path, monkeypatch, name):
    path = tmp_path / name
    (path / "RawData").mkdir(parents=True)
    monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(path))
    return str(path / "RawData")


def _write(path, text, encoding="utf-8"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding=encoding) as f:
        f.write(text)


def _assert_frames_equal(got, want, label):
    assert list(got) == list(want.columns), label
    for column in want.columns:
        assert got[column].dtype == want[column].dtype, (label, column)
        np.testing.assert_array_equal(got[column], want[column].to_numpy(),
                                      err_msg=f"{label} {column}")


def _assert_same_dataset(jax_dir, port_dir, tables=FEATHER_FRAMES, csvs=CSV_TABLES):
    for feather_name, frame_name in tables:
        _assert_frames_equal(read_frame(os.path.join(port_dir, frame_name)),
                             pd.read_feather(os.path.join(jax_dir, feather_name)), frame_name)
    for name in (*csvs, C.DESCRIPTION_JSON, C.DESCRIPTION_TXT):
        with open(os.path.join(jax_dir, name), "rb") as f_jax, \
                open(os.path.join(port_dir, name), "rb") as f_port:
            assert f_port.read() == f_jax.read(), name


def _run_both(tmp_path, monkeypatch, write_raw, format_name, *args, **kwargs):
    """Raw files into each package's work dir, each package's formatter;
    returns (jax dataset dir, port dataset dir)."""
    dirs = []
    for name, module in (("jax", jax_datasets), ("port", port_datasets)):
        raw = _work(tmp_path, monkeypatch, name)
        write_raw(raw)
        dirs.append(getattr(module, format_name)(*args, **kwargs))
    return dirs


def ml100k_raw(extra_user=True):
    def write(raw):
        d = os.path.join(raw, "MovieLens-100K")
        rows = [(2, 1, 5, 300), (1, 2, 3, 100), (1, 1, 4, 200), (2, 2, 1, 50)]
        if not extra_user:
            rows.append((3, 1, 2, 10))  # user 3 has no row in u.user: its features turn float
        _write(os.path.join(d, "u.data"), "".join("\t".join(map(str, r)) + "\n" for r in rows))
        _write(os.path.join(d, "u.user"),
               "1|24|M|technician|85711\n2|53|F|other|94043\n4|7|M|artist|11111\n")
        _write(os.path.join(d, "u.item.utf8"),
               "1|Toy Story (1995)|01-Jan-1995|||" + "|".join(["0"] * 3 + ["1"] + ["0"] * 15)
               + "\n2|GoldenEye (1967)|01-Jan-1967|||" + "|".join(["1"] + ["0"] * 18) + "\n"
               + "3|Unknown||||" + "|".join(["0"] * 19) + "\n")
    return write


def ml1m_raw(ages="25::15\n2::F::1::0"):
    def write(raw):
        d = os.path.join(raw, "MovieLens-1M")
        _write(os.path.join(d, "ratings.dat"),
               "1::10::5::300\n1::20::2::100\n2::10::4::50\n2::30::3::20\n")
        _write(os.path.join(d, "users.dat"), f"1::M::{ages}::54321\n3::M::56::7::1\n")
        _write(os.path.join(d, "movies.dat"),
               "10::Heat (1995)::Action|Crime|Thriller\n20::Sabrina (1995)::Comedy|Romance\n"
               "30::Amélie (2001)::Comedy\n40::Unseen (1999)::Drama\n", encoding="latin-1")
    return write


def ml10m_raw(raw):
    _write(os.path.join(raw, "MovieLens-10M", "ratings.dat"),
           "5::100::4.5::300\n5::200::2.0::100\n9::100::3.5::50\n12::7::5.0::40\n")


def amazon_raw(raw):
    rows = [
        {"reviewerID": "B", "asin": "Y", "overall": 5.0, "unixReviewTime": 200},
        {"reviewerID": "A", "asin": "X", "overall": 2.0, "unixReviewTime": 100},
        {"reviewerID": "A", "asin": "Y", "overall": 4.0, "unixReviewTime": 300},
        {"reviewerID": "a", "asin": "X10", "overall": 3.0, "unixReviewTime": 300},
        {"reviewerID": "A", "asin": "X2", "overall": 1.0, "unixReviewTime": 300},
    ]
    _write(os.path.join(raw, "reviews_Tiny_5.json"), "".join(json.dumps(r) + "\n" for r in rows))


def jester_raw(raw):
    _write(os.path.join(raw, "jester_ratings.dat"),
           "1\t\t7\t\t9.5\n1\t\t8\t\t-3.2\n2\t\t7\t\t0.0\n3\t\t1\t\t-0.5\n")


def xing_raw(raw):
    d = os.path.join(raw, "XING")
    os.makedirs(d)
    pd.DataFrame({
        "user_id": [10, 20, 30], "jobroles": ["1,2", "3", "4"], "career_level": [3, 4, 5],
        "discipline_id": [5, 6, 7], "industry_id": [7, 8, 9],
        "country": ["de", "non_dach", "ch"], "region": [1, 2, 3],
        "experience_n_entries_class": [1, 2, 3], "experience_years_experience": [3, 4, 5],
        "experience_years_in_current": [2, 1, 0], "edu_degree": [1, 2, 3],
        "edu_fieldofstudies": ["a", "b", "c"], "wtcj": [0, 1, 0], "premium": [1, 0, 1],
    }).to_csv(os.path.join(d, "users.csv"), sep="\t", index=False)
    pd.DataFrame({
        "item_id": [100, 200, 300], "title": ["t1", "t2", "t3"], "career_level": [3, 4, 1],
        "discipline_id": [5, 6, 2], "industry_id": [7, 8, 3], "country": ["at", "ch", "de"],
        "is_payed": [0, 1, 1], "region": [1, 2, 0], "latitude": [48.2, np.nan, -33.9],
        "longitude": [16.4, np.nan, 151.2], "employment": [1, 2, 1], "tags": ["x", "y", "z"],
        "created_at": [1480000000, 1490000000, 1420070400],
    }).to_csv(os.path.join(d, "items.csv"), sep="\t", index=False)
    pd.DataFrame({
        "user_id": [10, 10, 10, 20, 30, 30, 30],
        "item_id": [100, 100, 200, 100, 300, 200, 300],
        "interaction_type": [0, 2, 1, 4, 5, 3, 1],  # dup (10,100): keep the strongest (2)
        "created_at": [5, 6, 7, 8, 9, 3, 11],
    }).to_csv(os.path.join(d, "interactions.csv"), sep="\t", index=False)


def test_movielens_100k_matches_jax(tmp_path, monkeypatch):
    jax_dir, port_dir = _run_both(tmp_path, monkeypatch, ml100k_raw(), "format_movielens_100k",
                                  "ML100K-T")
    _assert_same_dataset(jax_dir, port_dir)
    assert read_frame(os.path.join(port_dir, C.USER_FRAME))["u_c_age"].tolist() == [1, 5, 0]


def test_movielens_100k_missing_user_turns_features_float(tmp_path, monkeypatch):
    jax_dir, port_dir = _run_both(tmp_path, monkeypatch, ml100k_raw(extra_user=False),
                                  "format_movielens_100k", "ML100K-M")
    _assert_same_dataset(jax_dir, port_dir)
    merged = read_frame(os.path.join(port_dir, C.INTERACTION_FRAME))
    assert merged["u_c_age"].dtype == np.float64 and np.isnan(merged["u_c_age"]).sum() == 1


@pytest.mark.parametrize("ages", ["25::15\n2::F::1::0", "9::15\n2::F::18::0"])
def test_movielens_1m_matches_jax(tmp_path, monkeypatch, ages):
    jax_dir, port_dir = _run_both(tmp_path, monkeypatch, ml1m_raw(ages), "format_movielens_1m",
                                  "ML1M-T")
    _assert_same_dataset(jax_dir, port_dir)
    assert read_frame(os.path.join(port_dir, C.ITEM_FRAME))[C.IID].tolist() == [1, 2, 3]


def test_movielens_10m_matches_jax(tmp_path, monkeypatch):
    jax_dir, port_dir = _run_both(tmp_path, monkeypatch, ml10m_raw, "format_movielens_10m",
                                  "ML10M-T")
    _assert_same_dataset(jax_dir, port_dir)


def test_amazon_matches_jax(tmp_path, monkeypatch):
    jax_dir, port_dir = _run_both(tmp_path, monkeypatch, amazon_raw, "format_amazon",
                                  "Amazon-T", "reviews_Tiny_5.json")
    _assert_same_dataset(jax_dir, port_dir)


def test_jester_matches_jax(tmp_path, monkeypatch):
    jax_dir, port_dir = _run_both(tmp_path, monkeypatch, jester_raw, "format_jester", "Jester-T")
    _assert_same_dataset(jax_dir, port_dir)
    assert read_frame(os.path.join(port_dir, C.BASE_INTERACTION_FRAME))[C.RATE].tolist() == \
        [9, -3, 0, 0]


def test_xing_matches_jax(tmp_path, monkeypatch):
    dirs, pre = [], []
    for name, module in (("jax", jax_datasets), ("port", port_datasets)):
        raw = _work(tmp_path, monkeypatch, name)
        xing_raw(raw)
        module.prepare_user_data()
        module.prepare_item_data()
        module.prepare_interaction_data()
        dirs.append(module.format_xing("XING-T"))
        pre.append(os.path.join(raw, "XING"))
    # the prepare steps' tables: feather in JAX, .npz frames in the port
    for kind in ("user", "item", "interaction"):
        _assert_frames_equal(read_frame(os.path.join(pre[1], f"pre_{kind}.npz")),
                             pd.read_feather(os.path.join(pre[0], f"pre_{kind}.feather")), kind)
    _assert_same_dataset(*dirs)
    items = read_frame(os.path.join(dirs[1], C.ITEM_FRAME))
    assert items["i_c_latitude"].dtype == np.int8


def criteo_raw(rows=900, chunk_rows=150, seed=0):
    """Criteo rows with pandas' missing-value strings, short lines (never the
    first of a chunk: pandas takes a chunk's width from it), blank lines,
    negative, fractional and text dense values and upper-case hex."""
    rng = np.random.default_rng(seed)
    na = ["NA", "nan", "NULL", "None", "#N/A", "", "n/a", "<NA>", "-NaN", "null"]
    lines = []
    for i in range(rows):
        label = str(rng.integers(0, 2)) if rng.random() > 0.05 else str(rng.choice(na))
        dense = [str(rng.integers(-3, 1000)) if rng.random() > 0.2 else str(rng.choice(na))
                 for _ in range(13)]
        if i % 7 == 3:
            dense[2] = "1.5e3"
        if i % 11 == 5:
            dense[4] = "abc"
        sparse = [format(int(rng.integers(0, 2 ** 32)), "08x") if rng.random() > 0.1
                  else str(rng.choice(na)) for _ in range(26)]
        if i % 9 == 2 and sparse[3] not in na:
            sparse[3] = sparse[3].upper()
        parts = [label] + dense + sparse
        if i % 13 == 4 and i % chunk_rows > 2:
            parts = parts[:30]
        lines.append("\t".join(parts))
        if i % 17 == 2:
            lines.append("")
    return "\n".join(lines) + "\n"


def _criteo_both(tmp_path, monkeypatch, text, **kwargs):
    def write(raw):
        _write(os.path.join(raw, "criteo", "train.txt"), text)
    return _run_both(tmp_path, monkeypatch, write, "format_criteo", "Criteo-T",
                     "criteo/train.txt", **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(hash_bucket=1000, rows_per_shard=200, sample_rows=300, chunk_rows=150),
    dict(hash_bucket=97, rows_per_shard=1000, chunk_rows=400),
])
def test_criteo_matches_jax(tmp_path, monkeypatch, kwargs):
    jax_dir, port_dir = _criteo_both(tmp_path, monkeypatch,
                                     criteo_raw(chunk_rows=kwargs["chunk_rows"]), **kwargs)
    jax_shards = sorted(glob.glob(os.path.join(jax_dir, "shards", "*.parquet")))
    port_shards = sorted(glob.glob(os.path.join(port_dir, "shards", "*.npz")))
    assert [os.path.basename(p)[:-len(".npz")] for p in port_shards] == \
        [os.path.basename(p)[:-len(".parquet")] for p in jax_shards]
    for jax_shard, port_shard in zip(jax_shards, port_shards):
        _assert_frames_equal(read_frame(port_shard), pd.read_parquet(jax_shard), port_shard)
    sample = "sample_rows" in kwargs
    _assert_same_dataset(jax_dir, port_dir, tables=FEATHER_FRAMES[:3] if sample else (),
                         csvs=())
    assert os.path.exists(os.path.join(port_dir, C.ITEM_FRAME)) == sample
    shard = read_frame(port_shards[0])
    assert list(shard) == [C.LABEL] + [f"d_{i}" for i in range(13)] + [f"c_{i}" for i in range(26)]
    assert (shard["d_0"] >= 0).all() and shard["c_0"].max() < kwargs["hash_bucket"]


def test_criteo_long_line_raises(tmp_path, monkeypatch):
    raw = _work(tmp_path, monkeypatch, "port")
    line = "\t".join(["1"] + ["2"] * 13 + ["0a"] * 26)
    _write(os.path.join(raw, "criteo", "train.txt"), f"{line}\n{line}\tx\n")
    with pytest.raises(ValueError, match="expected 40 fields in line 2"):
        port_datasets.format_criteo("Criteo-T", "criteo/train.txt", hash_bucket=10)
