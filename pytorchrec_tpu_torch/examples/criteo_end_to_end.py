"""End-to-end Criteo-style pipeline on the port (twin of
``examples/criteo_end_to_end.py``): raw TSV -> ``format_criteo`` (``.npz``
shards) -> ``StreamingBatchSource`` -> ``SparseEmbeddingTrainer.fit_steps``
with bf16 matmuls -> held-out AUC.

    PYTORCHREC_TPU_WORK_DIR=/tmp/criteo_demo \\
        python -m pytorchrec_tpu_torch.examples.criteo_end_to_end --rows 500000 --steps 200

runs on the card; ``--cpu`` runs it on the CPU. With real Criteo data,
point ``--raw`` at the train.txt (relative to the work dir's ``RawData``)
and skip ``--rows``. The flags and defaults are the JAX script's.

``--mesh d,m`` trains on a ``(d, m)`` mesh of ``d * m`` processes, each
running the script: ``torchrun --nproc_per_node=<d*m> -m
pytorchrec_tpu_torch.examples.criteo_end_to_end --mesh 1,2 ...`` (the
launcher sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the store's
address). The trainer is ``ShardedSparseEmbeddingTrainer`` over the packed
f32 tables (split over the model axis), DCN-v2's table rows rounded up to a
multiple of m; ``--hot_mass f`` (with ``--vocab_cap``: the admission pass's
``slot_counts()`` are the traffic counts) replicates the rows that carry
that share of the lookups on every rank, the rest split (``strategy=
"hot_cold"``). NCCL on the cards (``cuda:<LOCAL_RANK>``), gloo with
``--cpu`` or where more ranks than cards share them (``rank_device``).
Rank 0 alone formats the data (the others wait for it) and prints.
``--formatted`` trains on the shards an earlier run left in the work dir.

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
import torch
import torch.distributed as dist

from pytorchrec_tpu_torch.data.process.datasets import format_criteo
from pytorchrec_tpu_torch.data.streaming import StreamingBatchSource
from pytorchrec_tpu_torch.data.vocab import VocabMapper, build_vocabs
from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.metric import AUC
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.parallel import initialize_distributed, make_mesh
from pytorchrec_tpu_torch.training import ShardedSparseEmbeddingTrainer, SparseEmbeddingTrainer
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
    data = formatted(out, synth_s, time.perf_counter() - t0)
    log(f"{len(data['shards'])} shards; training on {len(data['train'])}, holding out "
        f"{os.path.basename(data['heldout'])}")
    return data


def formatted(out: Optional[str] = None, synth_s: float = 0.0, format_s: float = 0.0) -> dict:
    """The shards ``prepare`` wrote under ``out`` (the work dir's dataset by
    default): the last one held out."""
    out = out or os.path.join(C.dataset_dir(), DATASET)
    shard_dir = os.path.join(out, "shards")
    shards = [os.path.join(shard_dir, s) for s in sorted(os.listdir(shard_dir))]
    if len(shards) < 2:
        raise ValueError(f"{len(shards)} shard under {shard_dir}; the example holds one out")
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


def make_model(sparse, device=None, table_row_multiple: int = 1):
    """DCN-v2 over the 26 sparse and 13 dense fields: E=16, 3 cross layers,
    MLP (256, 128), the unified table (D = 429), its rows rounded up to a
    multiple of ``table_row_multiple``."""
    dense = tuple(NumericColumn(feature_name=f"d_{i}") for i in range(13))
    label = CategoricalColumnWithIdentity(feature_name="label", category_num=2)
    return DCNv2(sparse_columns=sparse, dense_columns=dense, label_column=label, emb_size=16,
                 num_cross_layers=3, layers=(256, 128), unified_embedding=True,
                 table_row_multiple=table_row_multiple, device=device)


def make_trainer(model, device=None, matmul_precision: Optional[str] = "bfloat16", mesh=None,
                 hot_counts: Optional[np.ndarray] = None, hot_mass: float = 0.0):
    """The packed f32 sparse trainer, compiled as the JAX script compiles;
    on a mesh its sharded twin, hot/cold where ``hot_mass`` and the unified
    table's ``hot_counts`` are given."""
    if mesh is None:
        trainer = SparseEmbeddingTrainer(model, device=device, packed_tables=True)
    elif hot_mass > 0:
        if hot_counts is None:
            raise ValueError("--hot_mass needs --vocab_cap (the traffic counts)")
        trainer = ShardedSparseEmbeddingTrainer(
            model, mesh=mesh, strategy="hot_cold", packed_tables=True,
            hot_counts={"unified": hot_counts, "unified_lin": hot_counts}, hot_rows=hot_mass)
    else:
        trainer = ShardedSparseEmbeddingTrainer(model, mesh=mesh, packed_tables=True)
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
        verbose: int = 1, log: Callable = print, mesh=None, hot_mass: float = 0.0,
        table_row_multiple: Optional[int] = None) -> dict:
    """The whole script: ``prepare`` (unless ``data`` is given: shards
    already made; on a ``mesh`` by rank 0, the others waiting), the vocab
    pass, ``fit_steps`` with a ``StepTimer``, the held-out AUC. Returns
    rows, shards, the table's rows and coverage, the window losses, p50
    ms/step, examples/s, the held-out AUC and the path's kernel launches in
    this run. On a mesh every rank calls it, and only rank 0 logs."""
    if mesh is not None and mesh.rank != 0:
        log, verbose = (lambda *args: None), 0
    if data is None:
        if mesh is None or mesh.rank == 0:
            data = prepare(rows, hash_bucket, raw, log)
        if mesh is not None:
            mesh.barrier()
            data = data or formatted()
    sparse, transform, vocab = vocab_transform(data["train"], batch, vocab_cap, hash_bucket,
                                               log)
    if table_row_multiple is None:
        table_row_multiple = 1 if mesh is None else mesh.model
    hot_counts = None if transform is None else np.concatenate(
        [transform.vocabs[f"c_{i}"].slot_counts() for i in range(26)])
    model = make_model(sparse, device if mesh is None else mesh.device, table_row_multiple)
    trainer = make_trainer(model, device, matmul_precision, mesh, hot_counts, hot_mass)
    if mesh is not None:
        log(f"{'hot/cold' if hot_mass > 0 else '1-D'} sharded tables over the "
            f"({mesh.data}, {mesh.model}) mesh" + (f": hot mass {hot_mass}" if hot_mass > 0
                                                   else ""))
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
    parser.add_argument("--formatted", action="store_true",
                        help="train on the shards an earlier run formatted in the work dir "
                             "(skips synthesis and formatting)")
    parser.add_argument("--mesh", default=None,
                        help="d,m: the sharded trainer on a (data, model) mesh of d*m ranks")
    parser.add_argument("--hot_mass", type=float, default=0.0,
                        help="with --mesh and --vocab_cap: replicate the rows carrying this "
                             "share of the lookups on every rank (hot/cold)")
    parser.add_argument("--cpu", action="store_true")
    return parser.parse_args(argv)


def rank_device(cpu: bool) -> dict:
    """``initialize_distributed``'s device and backend for this rank, from the
    launcher's environment: gloo on the CPU; NCCL on ``cuda:<LOCAL_RANK>``
    with a card a rank; gloo with ranks sharing the cards where the world
    has more ranks than there are cards (NCCL refuses two ranks on one)."""
    cards = 0 if cpu else torch.cuda.device_count()
    if cpu or not cards or int(os.environ.get("WORLD_SIZE", "1")) <= cards:
        return {"device": "cpu" if cpu else None}
    return {"device": f"cuda:{int(os.environ.get('LOCAL_RANK', '0')) % cards}",
            "backend": "gloo"}


def run_from_args(args: argparse.Namespace) -> dict:
    """``run`` as the command line asks; with ``--mesh`` this rank's part,
    the process group started from the launcher's environment on
    ``rank_device``'s device and backend (unless one exists) and left for
    the caller (``main`` ends the one it started). ``--hot_mass`` without
    ``--mesh`` and ``--vocab_cap`` raises ValueError (the JAX script asserts
    the counts and ignores the mass without a mesh)."""
    if args.hot_mass > 0 and not (args.mesh and args.vocab_cap):
        raise ValueError("--hot_mass needs --mesh and --vocab_cap (the traffic counts)")
    common = dict(rows=args.rows, steps=args.steps, batch=args.batch,
                  hash_bucket=args.hash_bucket, vocab_cap=args.vocab_cap, raw=args.raw,
                  data=formatted() if args.formatted else None)
    if not args.mesh:
        return run(device="cpu" if args.cpu else None, **common)
    place = rank_device(args.cpu)
    initialize_distributed(**place)
    d, m = map(int, args.mesh.split(","))
    return run(mesh=make_mesh(data=d, model=m, device=place["device"]), hot_mass=args.hot_mass,
               **common)


def main(argv=None) -> int:
    started = not dist.is_initialized()
    try:
        run_from_args(parse_args(argv))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
