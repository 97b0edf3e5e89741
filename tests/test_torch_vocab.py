"""The port's frequency vocab against the JAX package's, over the cases of
``tests/test_vocab.py`` (the hot/cold placement waits for the sharded
trainer; the streaming cases are in ``tests/test_torch_streaming.py``).

Each case runs the same updates, decays and build on both packages'
``FrequencyVocab`` and holds the port to JAX exactly (no tolerance):
``lookup`` (values and dtype, int32 on the direct-map, searchsorted and
mixed paths), ``slot_counts``, ``hot_rows``, ``coverage``, ``size``; a
vocab saved by either package loads in the other.
"""

import numpy as np
import pytest

from pytorchrec_tpu.data import vocab as jax_vocab
from pytorchrec_tpu_torch.data import vocab as port_vocab
from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity


def _admission(module):
    v = module.FrequencyVocab(num_oov_buckets=2)
    v.update(np.array([7, 7, 3, 0, 7, 9, 3, 7, 0, 3, 7]))
    return v.build(min_count=2)


def _max_size(module):
    v = module.FrequencyVocab()
    v.update(np.repeat(np.arange(1, 11), np.arange(1, 11)))
    return v.build(max_size=3)


def _multi_update(module):
    v = module.FrequencyVocab()
    ids = np.random.default_rng(0).integers(1, 500, size=10_000)
    for part in np.array_split(ids, 7):
        v.update(part)
    return v.build(min_count=3)


def _decay(module):
    v = module.FrequencyVocab()
    v.update(np.array([1] * 10 + [2] * 10))
    v.decay(0.1)
    v.update(np.array([2] * 9))
    return v.build(min_count=5)


def _empty(module):
    v = module.FrequencyVocab()
    v.update(np.array([5, 5, 5]))
    return v.build(min_count=100)


def _zipf(module):
    rng = np.random.default_rng(5)
    ids = rng.zipf(1.8, size=20_000).astype(np.int64)
    ids[rng.random(ids.shape) < 0.05] = 0
    v = module.FrequencyVocab(num_oov_buckets=4)
    v.update(ids)
    return v.build(max_size=50)


def _ties(module):
    """Equal counts: the lower id ranks first (``lexsort((ids, -cnt))``)."""
    v = module.FrequencyVocab(num_oov_buckets=3)
    v.update(np.array([40, 10, 30, 20, 40, 10, 30, 20, 5]))
    return v.build(max_size=3)


def _searchsorted(module):
    """Too wide a span for the direct map: the searchsorted path."""
    v = module.FrequencyVocab(num_oov_buckets=7)
    v.update((np.random.default_rng(2).zipf(1.5, size=8192) * 7919 % 1_000_000_007)
             .astype(np.int64))
    return v.build(min_count=2, max_size=500)


def _negative(module):
    """A negative admitted id: no direct map."""
    v = module.FrequencyVocab(num_oov_buckets=7)
    v.update(np.array([-5, -5, -5, 7, 7, 7, 3, 3, 3, 9], np.int64))
    return v.build(min_count=2.0)


def _huge(module):
    """int64 hashes near both ends: the mixer's uint64 wraparound."""
    big = np.array([2 ** 63 - 1, -(2 ** 63), 2 ** 62 + 3, -12345678901234], np.int64)
    v = module.FrequencyVocab(num_oov_buckets=5)
    v.update(np.concatenate([np.repeat(big[:2], 3), big[2:]]))
    return v.build(min_count=2)


def _consolidated(module):
    """Many updates past the pending limit (set low): merged as they come."""
    v = module.FrequencyVocab(num_oov_buckets=2)
    rng = np.random.default_rng(9)
    for _ in range(12):
        v.update(rng.integers(0, 300, size=200))
    v.decay(0.5)
    v.update(rng.integers(0, 900, size=500))
    return v.build(min_count=1.5, max_size=120)


CASES = {f.__name__[1:]: f for f in (_admission, _max_size, _multi_update, _decay, _empty,
                                     _zipf, _ties, _searchsorted, _negative, _huge,
                                     _consolidated)}


def _probe():
    rng = np.random.default_rng(11)
    return np.concatenate([
        rng.integers(0, 600, size=2000), rng.integers(5_000, 10_000_000, size=200),
        rng.integers(-1_000, 0, size=64), np.zeros(8, np.int64),
        np.array([7, 3, 9, 12345, -5, 2 ** 63 - 1, -(2 ** 63), 2 ** 62 + 3], np.int64),
        (rng.zipf(1.5, size=500) * 7919 % 1_000_000_007)]).astype(np.int64)


def _assert_same(got, want):
    assert (got.size, got.admitted_size, got.coverage) == \
        (want.size, want.admitted_size, want.coverage)
    assert (got._direct is None) == (want._direct is None)
    probe = _probe()
    out = got.lookup(probe)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, want.lookup(probe))
    grid = probe[:2000].reshape(40, 50)
    np.testing.assert_array_equal(got(grid), want(grid))
    assert got(grid).shape == (40, 50)
    np.testing.assert_array_equal(got.slot_counts(), want.slot_counts())
    for fraction in (0.0, 0.5, 0.8, 0.9, 1.0):
        assert got.hot_rows(fraction) == want.hot_rows(fraction)


@pytest.mark.parametrize("case", list(CASES))
def test_vocab_matches_jax(case, monkeypatch):
    if case == "consolidated":
        monkeypatch.setattr(jax_vocab, "_CONSOLIDATE_AT", 500)
        monkeypatch.setattr(port_vocab, "_CONSOLIDATE_AT", 500)
    _assert_same(CASES[case](port_vocab), CASES[case](jax_vocab))


@pytest.mark.parametrize("case", ["zipf", "searchsorted", "negative", "empty"])
def test_saved_vocab_loads_in_the_other_package(case, tmp_path):
    port, jax = CASES[case](port_vocab), CASES[case](jax_vocab)
    port.save(str(tmp_path / "port.npz"))
    jax.save(str(tmp_path / "jax.npz"))
    _assert_same(port_vocab.FrequencyVocab.load(str(tmp_path / "jax.npz")), jax)
    _assert_same(jax_vocab.FrequencyVocab.load(str(tmp_path / "port.npz")), port)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_direct_map_matches_searchsorted():
    fast, slow = port_vocab.FrequencyVocab(7), port_vocab.FrequencyVocab(7)
    slow.DIRECT_MAP_LIMIT = 0
    stream = np.random.default_rng(11).zipf(1.3, size=50_000).astype(np.int64) % 5_000
    for v in (fast, slow):
        v.update(stream)
        v.build(min_count=2.0, max_size=1_000)
    assert fast._direct is not None and slow._direct is None
    np.testing.assert_array_equal(fast.lookup(_probe()), slow.lookup(_probe()))


def test_splitmix64_is_the_jax_mixer():
    ids = np.concatenate([_probe(), np.array([-1, 2 ** 40], np.int64)])
    np.testing.assert_array_equal(port_vocab.splitmix64(ids), jax_vocab._scramble(ids))


def test_mapper_and_columns_match_jax():
    ports, jaxs = (m.build_vocabs([{"c": np.array([4, 4, 6, 9, 9, 9]), "d": np.ones(6)},
                                   {"c": np.array([6, 0, 11])}], ["c"], min_count=2,
                                  num_oov_buckets=3)
                   for m in (port_vocab, jax_vocab))
    _assert_same(ports["c"], jaxs["c"])
    batch = {"c": np.array([4, 6, 99, 0]), "d": np.array([1.5, 2.5, 3.5, 4.5])}
    got = port_vocab.VocabMapper(ports)(batch)
    want = jax_vocab.VocabMapper(jaxs)(batch)
    assert list(got) == list(want)
    np.testing.assert_array_equal(got["c"], want["c"])
    assert got["d"] is batch["d"]
    column = port_vocab.VocabMapper(ports).columns()["c"]
    assert isinstance(column, CategoricalColumnWithIdentity)
    assert column.category_num == jax_vocab.VocabMapper(jaxs).columns()["c"].category_num
