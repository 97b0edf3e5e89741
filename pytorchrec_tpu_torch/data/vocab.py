"""Frequency vocabularies for unbounded sparse features (port of
``pytorchrec_tpu/data/vocab.py``).

Vocabularies are frozen on the host before training, so a table's rows
are fixed before the first step: admission and eviction happen in the data
pipeline (``VocabMapper`` on the streaming source's producer thread), never
in a captured step.

Slot layout per feature::

    0                          reserved padding / missing
    1 .. num_oov_buckets       shared OOV buckets (scrambled hash of raw id)
    num_oov_buckets + 1 ..     admitted ids, ranked by DESCENDING frequency

``splitmix64`` is the one copy of the mixer that both the OOV buckets and
``format_criteo``'s id hashing use. ``save`` writes the JAX package's
``np.savez_compressed`` keys, so a vocab saved by either package loads in
the other.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np

from pytorchrec_tpu_torch.feature_column.categorical import CategoricalColumnWithIdentity

logger = logging.getLogger(__name__)

_CONSOLIDATE_AT = 4_000_000  # pending unique-chunk entries before a merge


def splitmix64(ids: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over ``ids`` as uint64: negative ids wrap to
    their two's complement and every product wraps mod 2**64, as in the
    JAX package (uint64 array arithmetic, never int64)."""
    z = np.asarray(ids).astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _oov_bucket(ids: np.ndarray, buckets: int) -> np.ndarray:
    """Each id's OOV bucket in ``[0, buckets)``, int64."""
    return (splitmix64(ids) % np.uint64(buckets)).astype(np.int64)


class FrequencyVocab:
    """Frequency-based admission vocabulary with shared OOV buckets.

    ``update(ids)`` any number of times (optionally ``decay(factor)``
    between windows for a rolling estimate), then ``build(min_count=...,
    max_size=...)`` fixes the id -> slot map; ``lookup`` / ``__call__`` then
    map raw id arrays to int32 slots.
    """

    # the direct map's ceiling: a flat int32 table of this many ids (32 MB)
    DIRECT_MAP_LIMIT = 8_000_000

    def __init__(self, num_oov_buckets: int = 1):
        assert num_oov_buckets >= 1
        self.num_oov_buckets = int(num_oov_buckets)
        self._ids = np.empty(0, np.int64)
        self._counts = np.empty(0, np.float64)
        self._zero_count = 0.0
        self._pending: list = []
        self._pending_len = 0
        self._admitted: Optional[np.ndarray] = None  # sorted by raw id
        self._slots: Optional[np.ndarray] = None     # slot per admitted entry
        # every in-range id's slot (admitted, OOV bucket or pad), when the
        # observed id space is small enough: lookup is then one gather
        self._direct: Optional[np.ndarray] = None

    # -------------------------------------------------- accumulation

    def update(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids).reshape(-1)
        self._zero_count += float((ids == 0).sum())
        uniq, cnt = np.unique(ids[ids != 0], return_counts=True)
        if uniq.size:
            self._pending.append((uniq.astype(np.int64), cnt.astype(np.float64)))
            self._pending_len += uniq.size
            if self._pending_len >= _CONSOLIDATE_AT:
                self._consolidate()

    def decay(self, factor: float) -> None:
        """Scale the accumulated counts by ``factor`` (a rolling window)."""
        self._consolidate()
        self._counts *= float(factor)
        self._zero_count *= float(factor)

    def _consolidate(self) -> None:
        if not self._pending:
            return
        all_ids = np.concatenate([self._ids] + [p[0] for p in self._pending])
        all_cnt = np.concatenate([self._counts] + [p[1] for p in self._pending])
        order = np.argsort(all_ids, kind="stable")
        all_ids, all_cnt = all_ids[order], all_cnt[order]
        uniq, start = np.unique(all_ids, return_index=True)
        summed = np.add.reduceat(all_cnt, start) if uniq.size else all_cnt
        self._ids, self._counts = uniq, summed
        self._pending, self._pending_len = [], 0

    # -------------------------------------------------- freeze

    def build(self, min_count: float = 1.0, max_size: Optional[int] = None) -> "FrequencyVocab":
        self._consolidate()
        keep = self._counts >= min_count
        ids, cnt = self._ids[keep], self._counts[keep]
        # descending frequency, ascending id as the tie-break
        order = np.lexsort((ids, -cnt))
        if max_size is not None:
            order = order[:max_size]
        ranked = ids[order]  # rank r -> raw id
        slots = np.arange(ranked.size, dtype=np.int64) + 1 + self.num_oov_buckets
        by_id = np.argsort(ranked, kind="stable")
        self._admitted = ranked[by_id]
        self._slots = slots[by_id]
        self._rank_counts = cnt[order].astype(np.float64)  # admitted, hot first
        # the tail's mass lands where lookup sends it: its OOV bucket
        tail = np.isin(self._ids, ranked, invert=True)
        self._oov_counts = np.bincount(_oov_bucket(self._ids[tail], self.num_oov_buckets),
                                       weights=self._counts[tail],
                                       minlength=self.num_oov_buckets)
        self._pad_count = self._zero_count
        self._admitted_count_total = float(self._rank_counts.sum())
        self._observed_count_total = float(self._counts.sum())
        self._bake_direct(int(max(self._ids.max(initial=0), self._admitted.max(initial=0))))
        logger.info("vocab: admitted %d/%d ids (coverage %.4f)",
                    ranked.size, self._ids.size, self.coverage)
        return self

    def _bake_direct(self, max_seen: int) -> None:
        """The direct map over ids ``0..max_seen``: admitted ids to their
        slot, every other id to its OOV bucket (the same hash as the
        searchsorted path), 0 to pad. Not built when the span passes
        ``DIRECT_MAP_LIMIT`` or when an admitted id is negative (a negative
        index would wrap into the table)."""
        self._direct = None
        if self._admitted.size and int(self._admitted.min()) < 0:
            return
        if 0 <= max_seen < self.DIRECT_MAP_LIMIT:
            span = np.arange(max_seen + 1, dtype=np.int64)
            direct = _oov_bucket(span, self.num_oov_buckets).astype(np.int32) + 1
            direct[0] = 0
            direct[self._admitted] = self._slots.astype(np.int32)
            self._direct = direct

    # -------------------------------------------------- frozen queries

    @property
    def built(self) -> bool:
        return self._admitted is not None

    @property
    def size(self) -> int:
        """Table rows needed: pad + OOV buckets + admitted ids."""
        assert self.built
        return 1 + self.num_oov_buckets + len(self._admitted)

    @property
    def admitted_size(self) -> int:
        assert self.built
        return len(self._admitted)

    @property
    def coverage(self) -> float:
        """Share of the observed (non-zero) mass mapped to owned slots."""
        assert self.built
        if self._observed_count_total == 0:
            return 1.0
        return self._admitted_count_total / self._observed_count_total

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Raw ids -> int32 slots of the same shape: 0 stays 0, admitted ids
        get their rank slot, every other id its OOV bucket's slot."""
        assert self.built, "call build() before lookup()"
        ids = np.asarray(ids)
        flat = ids.reshape(-1).astype(np.int64)
        if self._direct is not None:
            in_range = (flat >= 0) & (flat < self._direct.size)
            if in_range.all():
                return self._direct[flat].reshape(ids.shape)
            out = self._direct[np.where(in_range, flat, 0)]
            out[~in_range] = (_oov_bucket(flat[~in_range], self.num_oov_buckets)
                              .astype(np.int32) + 1)
            return out.reshape(ids.shape)
        n = len(self._admitted)
        pos = np.searchsorted(self._admitted, flat)
        if n:
            pos_c = np.minimum(pos, n - 1)
            hit = (pos < n) & (self._admitted[pos_c] == flat)
            out = np.where(hit, self._slots[pos_c], 0).astype(np.int64)
        else:
            hit = np.zeros(flat.shape, bool)
            out = np.zeros(flat.shape, np.int64)
        tail = ~hit  # only the misses are hashed
        if tail.any():
            out[tail] = _oov_bucket(flat[tail], self.num_oov_buckets) + 1
        out[flat == 0] = 0
        return out.reshape(ids.shape).astype(np.int32)

    __call__ = lookup

    def slot_counts(self) -> np.ndarray:
        """Observed traffic a slot over the ``[size]`` slot space: the pad's
        (the missing-value mass), each OOV bucket's tail mass, then the
        admitted slots in rank order (hottest first)."""
        assert self.built
        return np.concatenate([[self._pad_count], self._oov_counts, self._rank_counts])

    def hot_rows(self, mass_fraction: float = 0.9) -> int:
        """The fewest table rows that carry ``mass_fraction`` of the observed
        lookups."""
        counts = np.sort(self.slot_counts())[::-1]
        total = counts.sum()
        if total == 0:
            return 0
        covered = np.cumsum(counts)
        return int(np.searchsorted(covered, mass_fraction * total) + 1)

    def make_column(self, feature_name: str) -> CategoricalColumnWithIdentity:
        """A feature column sized to this vocabulary's slot space."""
        return CategoricalColumnWithIdentity(feature_name=feature_name, category_num=self.size)

    # -------------------------------------------------- persistence

    def save(self, path: str) -> None:
        assert self.built
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(
            path, admitted=self._admitted, slots=self._slots,
            num_oov_buckets=self.num_oov_buckets,
            totals=np.array([self._admitted_count_total, self._observed_count_total,
                             self._pad_count]),
            rank_counts=self._rank_counts, oov_counts=self._oov_counts,
        )

    @classmethod
    def load(cls, path: str) -> "FrequencyVocab":
        with np.load(path) as data:
            vocab = cls(num_oov_buckets=int(data["num_oov_buckets"]))
            vocab._admitted = data["admitted"]
            vocab._slots = data["slots"]
            totals = data["totals"]
            vocab._admitted_count_total = float(totals[0])
            vocab._observed_count_total = float(totals[1])
            vocab._pad_count = float(totals[2])
            vocab._rank_counts = data["rank_counts"]
            vocab._oov_counts = data["oov_counts"]
        vocab._bake_direct(int(vocab._admitted.max(initial=0)))
        return vocab


class VocabMapper:
    """Per-feature vocabularies applied to batch dicts: a
    ``StreamingBatchSource(transform=...)`` hook, run on the producer
    thread. Features without a vocabulary pass through untouched."""

    def __init__(self, vocabs: Mapping[str, FrequencyVocab]):
        for name, vocab in vocabs.items():
            assert vocab.built, f"vocab for {name!r} not built"
        self.vocabs = dict(vocabs)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {name: self.vocabs[name](values) if name in self.vocabs else values
                for name, values in batch.items()}

    def columns(self) -> Dict[str, CategoricalColumnWithIdentity]:
        return {name: vocab.make_column(name) for name, vocab in self.vocabs.items()}


def build_vocabs(chunks: Iterable[Mapping[str, np.ndarray]], features: Sequence[str],
                 min_count: float = 1.0, max_size: Optional[int] = None,
                 num_oov_buckets: int = 1) -> Dict[str, FrequencyVocab]:
    """One pass over ``chunks`` (column dicts, e.g.
    ``StreamingBatchSource(...).batches(epochs=1)``) -> a built vocab a
    feature."""
    vocabs = {name: FrequencyVocab(num_oov_buckets=num_oov_buckets) for name in features}
    for chunk in chunks:
        for name in features:
            if name in chunk:
                vocabs[name].update(chunk[name])
    for name in features:
        vocabs[name].build(min_count=min_count, max_size=max_size)
    return vocabs
