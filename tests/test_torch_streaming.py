"""The port's ``StreamingBatchSource`` against the JAX package's.

Four shards of the same rows are written as ``.csv``, ``.tsv``, ``.npz``
(the port's frames) and ``.parquet`` (JAX's). The port over ``.csv`` or
``.tsv`` against JAX over the same files, and the port over ``.npz``
against JAX over ``.parquet``, yield the same batches byte for byte (keys,
order, dtypes, values; no tolerance) for several seeds, per-process file
shards, interleaving, shuffle buffers, column subsets, two epochs and a
``VocabMapper`` transform. A shard with a missing value makes that chunk's
int column float64 in the CSV reading, as pandas types each chunk. A
missing pattern, a ``.parquet`` file and a text column raise.
"""

import threading

import numpy as np
import pandas as pd
import pytest

from pytorchrec_tpu.data.streaming import StreamingBatchSource as JaxSource
from pytorchrec_tpu.data.vocab import VocabMapper as JaxMapper, build_vocabs as jax_build
from pytorchrec_tpu_torch.data.process.io import write_frame
from pytorchrec_tpu_torch.data.streaming import StreamingBatchSource, read_csv_chunks
from pytorchrec_tpu_torch.data.vocab import VocabMapper, build_vocabs

ROWS = 1000


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    paths = {kind: [] for kind in ("csv", "tsv", "npz", "parquet")}
    for shard in range(4):
        frame = pd.DataFrame({
            "c_0": (rng.zipf(1.5, size=ROWS) * 7919 % 1_000_003).astype(np.int64),
            "c_1": rng.integers(0, 80, size=ROWS).astype(np.int32),
            "d_0": rng.normal(size=ROWS).astype(np.float32),
            "label": rng.integers(0, 2, size=ROWS).astype(np.int32),
            "shard": np.full(ROWS, shard, dtype=np.int32),
        })
        text = frame.copy()
        if shard == 2:  # a missing value: that chunk's c_1 reads as float64
            text["c_1"] = text["c_1"].astype("Int64")
            text.loc[5, "c_1"] = pd.NA
        for kind, sep in (("csv", ","), ("tsv", "\t")):
            path = str(root / f"part-{shard}.{kind}")
            text.to_csv(path, sep=sep, index=False)
            paths[kind].append(path)
        paths["parquet"].append(str(root / f"part-{shard}.parquet"))
        frame.to_parquet(paths["parquet"][-1])
        paths["npz"].append(str(root / f"part-{shard}.npz"))
        write_frame(paths["npz"][-1], {k: frame[k].to_numpy() for k in frame.columns})
    return paths


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


PAIRS = (("csv", "csv"), ("tsv", "tsv"), ("npz", "parquet"))
CONFIGS = {
    "default": dict(batch_size=256, chunk_rows=300, shuffle_buffer_chunks=3, seed=1),
    "interleave": dict(batch_size=100, chunk_rows=128, shuffle_buffer_chunks=2,
                       interleave_files=2, seed=7),
    "ordered": dict(batch_size=512, chunk_rows=1000, shuffle_files=False, seed=2020),
    "process_1_of_2": dict(batch_size=128, chunk_rows=250, process_id=1, process_count=2,
                           seed=3),
    "columns": dict(batch_size=64, chunk_rows=333, columns=["label", "c_1"], seed=5),
}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("port_kind,jax_kind", PAIRS)
def test_batches_match_jax(shards, port_kind, jax_kind, config):
    kwargs = CONFIGS[config]
    got = list(StreamingBatchSource(shards[port_kind], **kwargs).batches(epochs=2))
    want = list(JaxSource(shards[jax_kind], **kwargs).batches(epochs=2))
    _assert_same_batches(got, want)


def test_csv_chunks_are_typed_as_pandas_types_them(shards):
    path = shards["csv"][2]
    got = list(read_csv_chunks(path, ",", 300))
    want = list(pd.read_csv(path, sep=",", chunksize=300))
    assert [c["c_1"].dtype for c in got] == [c["c_1"].dtype for c in want] == \
        [np.float64] + [np.int64] * 3
    for a, b in zip(got, want):
        assert list(a) == list(b.columns)
        for key in b.columns:
            np.testing.assert_array_equal(a[key], b[key].to_numpy())


@pytest.mark.parametrize("port_kind,jax_kind", PAIRS)
def test_vocab_transform_matches_jax(shards, port_kind, jax_kind):
    kwargs = dict(batch_size=256, chunk_rows=400, shuffle_files=False, seed=3)
    vocabs = build_vocabs(StreamingBatchSource(shards[port_kind], **kwargs).batches(epochs=1),
                          ["c_0"], min_count=2, max_size=50, num_oov_buckets=8)
    jax_vocabs = jax_build(JaxSource(shards[jax_kind], **kwargs).batches(epochs=1), ["c_0"],
                           min_count=2, max_size=50, num_oov_buckets=8)
    np.testing.assert_array_equal(vocabs["c_0"].slot_counts(), jax_vocabs["c_0"].slot_counts())
    kwargs = dict(batch_size=128, chunk_rows=300, seed=4)
    got = list(StreamingBatchSource(shards[port_kind], transform=VocabMapper(vocabs),
                                    **kwargs).batches(epochs=1))
    want = list(JaxSource(shards[jax_kind], transform=JaxMapper(jax_vocabs),
                          **kwargs).batches(epochs=1))
    _assert_same_batches(got, want)
    assert max(int(b["c_0"].max()) for b in got) < vocabs["c_0"].size


def test_missing_pattern_and_parquet_raise(shards, tmp_path):
    with pytest.raises(AssertionError):
        StreamingBatchSource(str(tmp_path / "zzz-*.npz"), batch_size=8)
    with pytest.raises(ValueError, match=r"\.npz"):
        StreamingBatchSource(shards["parquet"], batch_size=8)
    with pytest.raises(AssertionError, match="got no files"):
        StreamingBatchSource(shards["npz"][:1], batch_size=8, process_id=1, process_count=2)


def test_text_column_raises_in_the_consumer(tmp_path):
    path = str(tmp_path / "text.csv")
    pd.DataFrame({"x": np.arange(10), "name": [f"n{i}" for i in range(10)]}).to_csv(
        path, index=False)
    with pytest.raises(ValueError, match="name"):
        list(StreamingBatchSource([path], batch_size=4).batches(epochs=1))
    assert len(list(StreamingBatchSource([path], batch_size=4, columns=["x"]).batches(
        epochs=1))) == 2


def test_closing_the_stream_ends_the_producer(shards):
    before = set(threading.enumerate())
    stream = StreamingBatchSource(shards["npz"], batch_size=64, chunk_rows=100,
                                  queue_depth=1).batches(epochs=None)
    next(stream)
    (producer,) = set(threading.enumerate()) - before
    stream.close()
    producer.join(timeout=10)
    assert not producer.is_alive()
