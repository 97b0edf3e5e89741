"""Synthetic dataset generators in the port's on-disk format (port of
``pytorchrec_tpu/data/process/datasets/synthetic.py``).

They write the frames the readers read (``base_interaction.npz``,
``interaction.npz``, ``item.npz``, ``user.npz``; ``data/process/io.py``)
and the description, with numpy in place of pandas: the same generator
draws in the same order, the same columns, order, dtypes and rows as the
JAX package's feather tables for the same arguments.

* ``generate_synthetic_ml``: MovieLens-like explicit-feedback interactions
  (uid/iid/rate/label/time) for the ranking-model families.
* ``generate_synthetic_ctr``: Criteo-like CTR rows (dense float features,
  sparse categorical features, a binary label) for DeepFM/DCN/DIN configs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from pytorchrec_tpu_torch.data.process.io import Frame, write_frame
from pytorchrec_tpu_torch.data.schema import DatasetDescription, FeatureMeta
from pytorchrec_tpu_torch.utils import constants as C


def _write_frames(dataset_name: str, interactions: Frame, base_columns, items: Frame,
                  users: Optional[Frame] = None) -> str:
    out_dir = os.path.join(C.dataset_dir(), dataset_name)
    os.makedirs(out_dir, exist_ok=True)
    write_frame(os.path.join(out_dir, C.BASE_INTERACTION_FRAME),
                {c: interactions[c] for c in base_columns})
    write_frame(os.path.join(out_dir, C.INTERACTION_FRAME), interactions)
    write_frame(os.path.join(out_dir, C.ITEM_FRAME), items)
    if users is not None:
        write_frame(os.path.join(out_dir, C.USER_FRAME), users)
    return out_dir


def _sorted_by_uid_time(frame: Frame) -> Frame:
    """Rows in (uid, time) order, ties in row order (a stable sort)."""
    order = np.lexsort((frame[C.TIME], frame[C.UID]))
    return {name: values[order] for name, values in frame.items()}


def generate_synthetic_ml(
    dataset_name: str = "Synthetic-ML",
    n_users: int = 200,
    n_items: int = 500,
    min_interactions: int = 20,
    max_interactions: int = 60,
    positive_rate_threshold: int = 4,
    seed: int = 2020,
    sequential_strength: float = 0.0,
    markov_strength: float = 0.0,
    n_clusters: int = 20,
) -> str:
    """MovieLens-like dataset: 1-based uid/iid (0 reserved for PAD), rows
    sorted by (uid, time), label = rate >= threshold.

    ``sequential_strength > 0`` adds a first-order sequential signal: each
    positive raises the affinity of the previous item's latent neighbors, so
    session models (GRU4Rec/SASRec/DIN) have order structure to exploit —
    with 0 the preference is static and only factorization models can win.

    ``markov_strength > 0`` plants structure in the item CHOICE itself (not
    just the rating): items belong to ``n_clusters`` clusters with a fixed
    successor permutation, and each interaction follows the previous item's
    successor cluster with probability ``markov_strength`` (else uniform).
    Followed transitions get a rating bonus so the chain survives in the
    positive history. Under leave-k-out ranking eval the held-out item's
    cluster is therefore PREDICTABLE from history order — sequence models
    can localize ~n_items/n_clusters candidates while factorization models
    see only the (weak) static affinity. This is the discriminative
    benchmark for the sequence zoo.
    """
    rng = np.random.default_rng(seed)

    uid_rows = []
    iid_rows = []
    time_rows = []
    rate_rows = []
    # simple latent preference structure so models can actually learn
    user_vec = rng.normal(size=(n_users + 1, 4))
    item_vec = rng.normal(size=(n_items + 1, 4))
    if markov_strength > 0:
        item_cluster = rng.integers(0, n_clusters, size=n_items + 1)
        cluster_items = [np.flatnonzero(item_cluster[1:] == c) + 1
                         for c in range(n_clusters)]
        # every cluster must be non-empty for the chain to be followable
        assert all(len(ci) > 0 for ci in cluster_items), (
            f"n_items={n_items} too small for n_clusters={n_clusters}")
        succ = rng.permutation(n_clusters)
    for uid in range(1, n_users + 1):
        n = int(rng.integers(min_interactions, max_interactions + 1))
        followed = np.zeros(n, dtype=bool)
        if markov_strength > 0:
            seq = np.empty(n, dtype=np.int64)
            used = set()

            def _draw(pool):
                # rejection-sample a few times to keep (uid, iid) pairs
                # unique; fall back to a duplicate rather than loop forever
                for _ in range(10):
                    cand = int(pool[rng.integers(len(pool))])
                    if cand not in used:
                        return cand
                return None

            all_items = np.arange(1, n_items + 1)
            cur = int(rng.integers(1, n_items + 1))
            seq[0] = cur
            used.add(cur)
            for t in range(1, n):
                nxt = None
                if rng.random() < markov_strength:
                    pool = cluster_items[succ[item_cluster[cur]]]
                    nxt = _draw(pool)
                    followed[t] = nxt is not None
                if nxt is None:
                    nxt = _draw(all_items)
                    if nxt is None:
                        nxt = int(rng.integers(1, n_items + 1))
                seq[t] = nxt
                used.add(nxt)
                cur = nxt
            iids = seq
        else:
            iids = rng.choice(np.arange(1, n_items + 1), size=n, replace=False)
        affinity = (user_vec[uid] * item_vec[iids]).sum(axis=1)
        # chain-following steps rate positive so pos_his carries the chain
        # (+2.5 puts ~80% of followed steps above the rating threshold)
        affinity = affinity + 2.5 * followed
        if sequential_strength > 0:
            # order-dependent term: similarity of each item to its
            # predecessor's latent vector (first item keeps its base score)
            prev_sim = np.zeros(n)
            prev_sim[1:] = (item_vec[iids[1:]] * item_vec[iids[:-1]]).sum(axis=1)
            affinity = affinity + sequential_strength * prev_sim
        noise = rng.normal(scale=1.0, size=n)
        rates = np.clip(np.round(3 + affinity + noise), 1, 5).astype(np.int64)
        times = np.sort(rng.integers(1_000_000, 2_000_000, size=n))
        uid_rows.append(np.full(n, uid, dtype=np.int64))
        iid_rows.append(iids.astype(np.int64))
        time_rows.append(times.astype(np.int64))
        rate_rows.append(rates)

    frame = {
        C.UID: np.concatenate(uid_rows),
        C.IID: np.concatenate(iid_rows),
        C.RATE: np.concatenate(rate_rows),
        C.TIME: np.concatenate(time_rows),
    }
    frame[C.LABEL] = (frame[C.RATE] >= positive_rate_threshold).astype(np.int64)
    frame = _sorted_by_uid_time(frame)
    base_columns = [C.UID, C.IID, C.RATE, C.LABEL, C.TIME]
    # the canonical format stores integer columns as int32
    frame = {name: values.astype(np.int32) for name, values in frame.items()}

    # one small categorical item feature; iid row i-1 corresponds to item i
    items = {
        C.IID: np.arange(1, n_items + 1, dtype=np.int32),
        "i_c_genre": rng.integers(0, 8, size=n_items).astype(np.int32),
    }
    users = {
        C.UID: np.arange(1, n_users + 1, dtype=np.int32),
        "u_c_group": rng.integers(0, 4, size=n_users).astype(np.int32),
    }

    out_dir = _write_frames(dataset_name, frame, base_columns, items, users)

    description = DatasetDescription(
        info=f"synthetic movielens-like dataset ({n_users} users x {n_items} items)",
        base_features=[FeatureMeta(c, C.CATEGORICAL_COLUMN) for c in base_columns],
        item_features=[FeatureMeta("i_c_genre", C.CATEGORICAL_COLUMN)],
        user_features=[FeatureMeta("u_c_group", C.CATEGORICAL_COLUMN)],
    )
    description.compute_interaction_stats(frame[C.UID], frame[C.LABEL])
    description.save(dataset_name)
    return out_dir


def generate_synthetic_ctr(
    dataset_name: str = "Synthetic-Criteo",
    n_rows: int = 100_000,
    n_dense: int = 13,
    sparse_vocab_sizes: Optional[Dict[str, int]] = None,
    seed: int = 2020,
    with_conversion: bool = False,
) -> str:
    """Criteo-like CTR dataset: dense float features ``d_0..``, sparse
    categorical features ``c_0..``, binary label with planted structure.

    ``with_conversion=True`` adds a post-click ``conversion`` label (its own
    planted structure, nonzero only where ``label``/click is 1 — the real
    CVR funnel) for the multi-task family (models/multitask.py): SharedBottom
    /MMoE/PLE train on (label, conversion); ESMM on the entire-space
    product."""
    rng = np.random.default_rng(seed)
    if sparse_vocab_sizes is None:
        sparse_vocab_sizes = {f"c_{i}": int(v) for i, v in enumerate(
            [1000, 500, 200, 100, 50, 20, 10] * 4)}  # 28 sparse fields

    data: Dict[str, np.ndarray] = {}
    logits = np.zeros(n_rows)
    for i in range(n_dense):
        col = rng.lognormal(mean=0.0, sigma=1.0, size=n_rows).astype(np.float32)
        data[f"d_{i}"] = col
        logits += 0.05 * (i % 3 - 1) * np.log1p(col)
    for name, vocab in sparse_vocab_sizes.items():
        ids = rng.integers(0, vocab, size=n_rows).astype(np.int64)
        data[name] = ids
        field_effect = rng.normal(scale=0.3, size=vocab)
        logits += field_effect[ids]
    label = (rng.random(n_rows) < 1 / (1 + np.exp(-(logits - 1.0)))).astype(np.int64)

    frame: Frame = dict(data)
    frame[C.LABEL] = label
    if with_conversion:
        # conversion has its OWN planted structure (reweighted dense terms +
        # a per-field effect on c_1) and fires only on clicked rows
        conv_logits = np.zeros(n_rows)
        for i in range(n_dense):
            conv_logits += 0.08 * ((i + 1) % 3 - 1) * np.log1p(data[f"d_{i}"])
        conv_vocab = sparse_vocab_sizes.get("c_1")
        if conv_vocab:
            conv_effect = rng.normal(scale=0.4, size=conv_vocab)
            conv_logits += conv_effect[data["c_1"]]
        conv = (rng.random(n_rows)
                < 1 / (1 + np.exp(-(conv_logits - 0.5)))).astype(np.int64)
        frame["conversion"] = (label * conv).astype(np.int64)
    # canonical reader-compatible skeleton: synthetic uid/iid/rate/time so the
    # standard readers (splits, candidate eval, CLI) work on CTR data too
    n_users = max(2, n_rows // 50)
    frame[C.UID] = (rng.integers(1, n_users + 1, size=n_rows)).astype(np.int32)
    frame[C.IID] = data["c_0"].astype(np.int32) + 1  # reuse field 0 as the "item"
    frame[C.RATE] = frame[C.LABEL].astype(np.int32)
    frame[C.TIME] = np.arange(n_rows, dtype=np.int32)
    frame[C.LABEL] = frame[C.LABEL].astype(np.int32)  # keeps its place in the order
    frame = _sorted_by_uid_time(frame)
    base_columns = [C.UID, C.IID, C.RATE, C.LABEL, C.TIME]

    items = {C.IID: np.arange(1, int(frame[C.IID].max()) + 1, dtype=np.int32)}
    out_dir = _write_frames(dataset_name, frame, base_columns, items)

    description = DatasetDescription(
        info=f"synthetic criteo-like CTR dataset ({n_rows} rows)",
        base_features=[FeatureMeta(C.LABEL, C.CATEGORICAL_COLUMN)],
        context_features=(
            [FeatureMeta(f"d_{i}", C.NUMERIC_COLUMN) for i in range(n_dense)]
            + [FeatureMeta(name, C.CATEGORICAL_COLUMN, {"vocab": v})
               for name, v in sparse_vocab_sizes.items()]
            + ([FeatureMeta("conversion", C.CATEGORICAL_COLUMN, {"vocab": 2})]
               if with_conversion else [])
        ),
    )
    description.save(dataset_name)
    return out_dir
