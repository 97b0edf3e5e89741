"""End-to-end Criteo-style pipeline on the port (twin of
``examples/criteo_end_to_end.py``): raw TSV -> ``format_criteo`` (``.npz``
shards) -> ``StreamingBatchSource`` -> ``SparseEmbeddingTrainer.fit_steps``
with bf16 matmuls -> held-out AUC.

    PYTORCHREC_TPU_WORK_DIR=/tmp/criteo_demo \\
        python -m pytorchrec_tpu_torch.examples.criteo_end_to_end --rows 500000 --steps 200

runs on the card; ``--cpu`` runs it on the CPU. With real Criteo data,
point ``--raw`` at the train.txt (relative to the work dir's ``RawData``)
and skip ``--rows``. The flags and defaults are the JAX script's;
``--mesh`` and ``--hot_mass`` (the sharded trainer) raise until the
multi-device work is ported.

``synth_raw_tsv`` draws what the JAX script's draws, in its order, and
writes the same bytes. The model is DCN-v2 with the unified table (E=16,
3 cross layers, MLP 256-128) under the packed f32 sparse trainer, Adam
lr 1e-3, BCE, ``matmul_precision="bfloat16"``. ``run`` returns what the
run measured (``chip_smoke.py`` phase 40 calls it); ``prepare``,
``vocab_transform``, ``make_model``, ``make_trainer`` and ``heldout_scores``
are its steps.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np

from pytorchrec_tpu_torch.data.process.datasets import format_criteo
from pytorchrec_tpu_torch.data.streaming import StreamingBatchSource
from pytorchrec_tpu_torch.data.vocab import VocabMapper, build_vocabs
from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.metric import AUC
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer
from pytorchrec_tpu_torch.utils import constants as C
from pytorchrec_tpu_torch.utils.profiling import StepTimer

HELDOUT_BATCHES = 11  # held-out batches scored (the JAX script's loop)
RAW_NAME = "criteo_demo/train.txt"
DATASET = "Criteo-Demo"
SCAN_CHUNK_ROWS = 65536
SYNTH_BLOCK = 100_000  # rows drawn and written a block at a time, as the JAX script


def synth_raw_tsv(path: str, rows: int, seed: int = 0) -> None:
    """Criteo-format synthetic raw file with planted signal: the JAX
    script's draws in its order (each row's 13 dense then 26 sparse keep
    draws are consecutive doubles of the stream, so one ``random((n, 39))``
    draws them), formatted to its bytes."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    field_effects = [rng.normal(scale=0.4, size=1000) for _ in range(26)]
    dense_text = np.array([str(v) for v in range(200)], dtype=object)
    cat_text = np.array([format(v, "08x") for v in range(1000)], dtype=object)
    with open(path, "w") as f:
        for start in range(0, rows, SYNTH_BLOCK):
            n = min(SYNTH_BLOCK, rows - start)
            dense = rng.integers(0, 200, size=(n, 13))
            cats = rng.integers(0, 1000, size=(n, 26))
            logits = sum(field_effects[j][cats[:, j]] for j in range(26))
            label = (rng.random(n) < 1 / (1 + np.exp(-(logits - 0.5)))).astype(int)
            keep = rng.random((n, 39))
            table = np.empty((n, 40), dtype=object)
            table[:, 0] = np.where(label == 1, "1", "0")
            table[:, 1:14] = np.where(keep[:, :13] > 0.1, dense_text[dense], "")
            table[:, 14:] = np.where(keep[:, 13:] > 0.05, cat_text[cats], "")
            f.write("\n".join("\t".join(row) for row in table.tolist()) + "\n")


def prepare(rows: int, hash_bucket: int, raw: Optional[str] = None,
            log: Callable = print) -> dict:
    """The raw TSV (synthesised when ``raw`` is None and it is absent) into
    ``.npz`` shards of a quarter of the rows each (at least 2 shards: they
    flush a chunk at a time); the last shard is held out."""
    raw_name = raw or RAW_NAME
    raw_abs = os.path.join(C.raw_data_dir(), raw_name)
    synth_s = 0.0
    if raw is None and not os.path.exists(raw_abs):
        log(f"synthesizing {rows} raw rows ...")
        t0 = time.perf_counter()
        synth_raw_tsv(raw_abs, rows)
        synth_s = time.perf_counter() - t0
    rows_per_shard = max(rows // 4, 1)
    t0 = time.perf_counter()
    out = format_criteo(DATASET, raw_name, hash_bucket=hash_bucket,
                        rows_per_shard=rows_per_shard, chunk_rows=max(rows_per_shard // 2, 1))
    format_s = time.perf_counter() - t0
    shard_dir = os.path.join(out, "shards")
    shards = [os.path.join(shard_dir, s) for s in sorted(os.listdir(shard_dir))]
    if len(shards) < 2:
        raise ValueError(f"{rows} rows gave {len(shards)} shard; the example holds one out")
    log(f"{len(shards)} shards; training on {len(shards) - 1}, holding out "
        f"{os.path.basename(shards[-1])}")
    return {"dir": out, "shards": shards, "train": shards[:-1], "heldout": shards[-1],
            "synth_s": synth_s, "format_s": format_s}


def vocab_transform(train_shards, batch: int, vocab_cap: int, hash_bucket: int,
                    log: Callable = print):
    """The sparse columns, the chunk transform (None, or a ``VocabMapper``
    of frequency vocabs capped at ``vocab_cap`` ids a field with 16 OOV
    buckets, built in one pass over the train shards) and the table's
    rows and mean coverage."""
    if not vocab_cap:
        sparse = tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                     category_num=hash_bucket)
                       for i in range(26))
        return sparse, None, {"rows": 26 * hash_bucket, "coverage": 1.0}
    log(f"building frequency vocabs (cap {vocab_cap}/feature) ...")
    scan = StreamingBatchSource(train_shards, batch_size=batch, chunk_rows=SCAN_CHUNK_ROWS,
                                shuffle_files=False, seed=0)
    vocabs = build_vocabs(scan.batches(epochs=1), [f"c_{i}" for i in range(26)],
                          min_count=2, max_size=vocab_cap, num_oov_buckets=16)
    coverage = float(np.mean([v.coverage for v in vocabs.values()]))
    rows = sum(v.size for v in vocabs.values())
    log(f"vocabs: {rows} total rows (vs {26 * hash_bucket} uncapped), mean coverage "
        f"{coverage:.4f}")
    sparse = tuple(vocabs[f"c_{i}"].make_column(f"c_{i}") for i in range(26))
    return sparse, VocabMapper(vocabs), {"rows": rows, "coverage": coverage}


def make_model(sparse, device=None):
    """DCN-v2 over the 26 sparse and 13 dense fields: E=16, 3 cross layers,
    MLP (256, 128), the unified table (D = 429)."""
    dense = tuple(NumericColumn(feature_name=f"d_{i}") for i in range(13))
    label = CategoricalColumnWithIdentity(feature_name="label", category_num=2)
    return DCNv2(sparse_columns=sparse, dense_columns=dense, label_column=label, emb_size=16,
                 num_cross_layers=3, layers=(256, 128), unified_embedding=True, device=device)


def make_trainer(model, device=None, matmul_precision: Optional[str] = "bfloat16"):
    """The packed f32 sparse trainer, compiled as the JAX script compiles."""

    trainer = SparseEmbeddingTrainer(model, device=device, packed_tables=True)
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=("auc",),
                    matmul_precision=matmul_precision)
    return trainer


def fixed_shape(batches: Iterable[Dict[str, np.ndarray]], size: int) -> Iterator[dict]:
    """``batches``, each checked to hold ``[size]`` in every column."""
    for batch in batches:
        bad = {k: v.shape for k, v in batch.items() if v.shape != (size,)}
        if bad:
            raise ValueError(f"batch columns {bad}, want ({size},)")
        yield batch


def train_source(data: dict, batch: int, transform=None):

    return StreamingBatchSource(data["train"], batch_size=batch, chunk_rows=SCAN_CHUNK_ROWS,
                                seed=1, transform=transform)


def heldout_scores(trainer, data: dict, batch: int, transform=None,
                   max_batches: int = HELDOUT_BATCHES):
    """Up to ``max_batches`` held-out batches through ``make_serving_fn``:
    (scores, labels) on the host."""

    serve = trainer.make_serving_fn()
    heldout = StreamingBatchSource([data["heldout"]], batch_size=batch,
                                   chunk_rows=SCAN_CHUNK_ROWS, shuffle_files=False, seed=2,
                                   transform=transform)
    scores, labels = [], []
    for i, item in enumerate(fixed_shape(heldout.batches(epochs=1), batch)):
        scores.append(serve(item).cpu().numpy())
        labels.append(item["label"])
        if i + 1 >= max_batches:
            break
    return np.concatenate(scores), np.concatenate(labels)


def path_launches() -> dict:
    """The launch counts of the kernels this path runs: B1 (the cross
    forward), B2 (the segmented scan) and B4 (the row scatter)."""
    return {k.__name__: k.launches for k in (cross_network, segmented_sum_scan,
                                             scatter_set_rows)}


def run(rows: int = 500_000, steps: int = 200, batch: int = 8192, hash_bucket: int = 100_000,
        vocab_cap: int = 0, raw: Optional[str] = None, device=None,
        matmul_precision: Optional[str] = "bfloat16", data: Optional[dict] = None,
        verbose: int = 1, log: Callable = print) -> dict:
    """The whole script: ``prepare`` (unless ``data`` is given: shards
    already made), the vocab pass, ``fit_steps`` with a ``StepTimer``, the
    held-out AUC. Returns rows, shards, the table's rows and coverage, the
    window losses, p50 ms/step, examples/s, the held-out AUC and the path's
    kernel launches in this run."""
    if data is None:
        data = prepare(rows, hash_bucket, raw, log)
    sparse, transform, vocab = vocab_transform(data["train"], batch, vocab_cap, hash_bucket,
                                               log)
    trainer = make_trainer(make_model(sparse, device), device, matmul_precision)
    before = path_launches()
    timer = StepTimer(batch_size=batch)
    t0 = time.perf_counter()
    history = trainer.fit_steps(fixed_shape(train_source(data, batch, transform).batches(), batch),
                                steps=steps, log_every=max(steps // 4, 1), verbose=verbose,
                                callbacks=[timer])
    train_s = time.perf_counter() - t0
    stats = timer.stats()
    log(f"steady-state: {stats.get('examples_per_sec', 0) / 1e6:.2f}M examples/sec "
        f"(p50 {stats.get('p50_s', 0) * 1e3:.2f} ms/step)")
    scores, labels = heldout_scores(trainer, data, batch, transform)
    auc = float(AUC()(scores, labels))
    log(f"held-out AUC: {auc:.4f}")
    after = path_launches()
    losses = trainer.step_losses.cpu().numpy()
    return {"rows": rows, "shards": len(data["shards"]), "table_rows": vocab["rows"],
            "coverage": vocab["coverage"], "window_losses": history.history["loss"],
            "step_losses": losses, "steps": int(len(losses)),
            "p50_ms": stats.get("p50_s", 0.0) * 1e3,
            "examples_per_s": stats.get("examples_per_sec", 0.0), "train_s": train_s,
            "heldout_auc": auc, "heldout_rows": int(len(scores)),
            "matmul_precision": matmul_precision, "synth_s": data["synth_s"],
            "format_s": data["format_s"],
            "launches": {k: after[k] - before[k] for k in after}, "trainer": trainer}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=500_000)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--hash_bucket", type=int, default=100_000)
    parser.add_argument("--vocab_cap", type=int, default=0,
                        help="if set, run a frequency-vocab admission pass: top-K ids per "
                             "feature own slots, the tail shares OOV buckets")
    parser.add_argument("--raw", default=None, help="existing raw TSV (skips synthesis)")
    parser.add_argument("--mesh", default=None, help="d,m: the sharded trainer (not ported)")
    parser.add_argument("--hot_mass", type=float, default=0.0,
                        help="hot rows replicated on every device (not ported)")
    parser.add_argument("--cpu", action="store_true")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mesh or args.hot_mass > 0:
        raise NotImplementedError("--mesh and --hot_mass need the sharded trainer, which is "
                                  "not ported yet (ROADMAP.md A10)")
    run(rows=args.rows, steps=args.steps, batch=args.batch, hash_bucket=args.hash_bucket,
        vocab_cap=args.vocab_cap, raw=args.raw, device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
