#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorchrec_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Phases; any failure ends the run with a non-zero exit and no result line:

1. card: the card's name and power limit (nvidia-smi) and torch's name for it;
2. build: every CUDA kernel of the serving and training paths (cross,
   seg_scan, scatter, requantize), from ``pytorchrec_tpu_torch/csrc``, one
   nvcc each, all at once;
3. kernel against plain: the cross kernel's wrapper on the card at the shapes
   the serving path gives it, held against its plain PyTorch version;
4. serving: DCN-v2 at the full Criteo width (26 sparse fields of 100k ids,
   E=16, 13 dense fields, 3 cross layers, MLP 256-128; ``bench.py``'s
   config), weights made from ``--seed`` in the flax leaf layout and loaded
   through ``params_from_jax``. It scores requests of 1, 1000, 4096 and 32768
   rows and one candidate request [256, 100], once with the f32 table (the
   packed ``table || moments`` leaf) and once with the int8 packed byte-row
   table. Launch counts are zeroed just before and read just after; each
   request must launch the cross kernel once, give finite scores of the right
   shape and agree with the same model run with the plain cross network on
   the card and, for the 1000-row request, on the CPU. One more 1-row and
   one more 32768-row request run under torch.profiler, which prints the
   device time by kernel and copy against the request's wall time;
5. cross timings: the cross kernel's time at 1, 4096 and 32768 rows beside
   its plain version, a cuBLAS yardstick and the card's bound;
6. training kernels against plain, on the card: the segmented scan at the
   packed update's shape (851,968 rows of E=16, ids drawn as ``bench.py``
   draws them), a Zipf-skewed case with segments of 10k+ rows and 1 and
   1000 rows; the scatter-set into a [2.6M, 64] f32 table (bit-exact); the
   cross network's gradient through its autograd Function against autograd
   through the plain version at B=4096; then each kernel's time beside its
   plain version, a PyTorch yardstick where one exists, and its bound, at
   the f32 and the int8 training step's shapes;
7. training: the same model under ``SparseEmbeddingTrainer(packed_tables=
   True)`` (lazy Adam on packed ``table || m || v`` rows, dense Adam, BCE),
   weights from ``--seed`` loaded through ``params_from_jax``, 25
   ``train_step``s on device-resident batches of 32768 rows made as
   ``bench.py``'s ``make_host_batch``, then ``fit_steps`` and the trained
   model's ``make_serving_fn``. Launch counts are zeroed just before and read
   just after: every step launches each of the three kernels once. Losses
   must be finite and the packed buffer never reallocated. It prints ms/step
   and examples/s (CUDA events over the last 20 steps), a torch.profiler
   breakdown of one more step and the peak device memory;
8. card against CPU: the same model and weights, 2 steps at batch 1024 on the
   card and on the CPU (plain versions), compared loss by loss and in the
   dense parameters and touched packed rows afterwards;
9. requantize against plain, on the card: the int8 update's kernel at its
   main-path shape (851,968 permuted 128-byte rows of a random int8 table
   gathered at ``bench.py``-drawn ids, grads summed by the scan, the step-1
   salt), at 1 and 1000 rows, with an all-zero row and with lr 10; then its
   time beside its plain version and its bound;
10. int8 training: phase 7 under ``QuantizedEmbeddingTrainer(packed_tables=
   True)`` (rowwise Adagrad and stochastic requantization of packed
   ``q || scale || acc`` byte rows, bench.py's headline ``int8-packed``
   configuration); every step launches each of the four kernels once, and
   the packed buffer stays the model's own ``unified_q``;
11. int8 card against CPU: phase 8 for the int8 trainer;

then a ``{"kernels": [...]}`` line with every kernel at its main-path shape
(``launches``: the int8 training run's; the f32 run's and serving's beside).
The last line is ``{"ok": true, "device": {...}}``. Needs one CUDA card; no
JAX and nothing of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.ops.kernels.build import build
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network, cross_network_plain
from pytorchrec_tpu_torch.ops.kernels.quantize import (
    quantize_rows,
    requantize_rows,
    requantize_rows_plain,
    table_rounding_salt,
)
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows, scatter_set_rows_plain
from pytorchrec_tpu_torch.ops.kernels.seg_scan import (
    segmented_sum_scan,
    segmented_sum_scan_plain,
)
from pytorchrec_tpu_torch.ops.quantized_packed import (
    dequant_packed_rows,
    pack_quantized_table,
    packed_q_base,
    packed_q_width,
    unpack_quantized_table,
)
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer, SparseEmbeddingTrainer, Trainer
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.rng import prng_key, split

# bench.py's Criteo-shaped DCN-v2
N_DENSE = 13
N_SPARSE = 26
VOCAB = 100_000
EMB = 16
CROSS_LAYERS = 3
MLP_UNITS = (256, 128)
DIM = N_SPARSE * EMB + N_DENSE  # 429
REQUEST_ROWS = (1, 1000, 4096, 32768)
CANDIDATES = (256, 100)  # [B, N] candidate request
REPEATS = 5  # timed repeats of each request
PROFILED_SHAPES = ((1,), (REQUEST_ROWS[-1],))  # one more request each, under torch.profiler

# training (bench.py): batch, steps timed after warm-up, packed row width
TRAIN_BATCH = 32768
TRAIN_WARMUP, TRAIN_TIMED = 5, 20
PACKED_W = 64  # f32 table || m || v || staging at E=16
Q_W = packed_q_width(EMB, 8, 1)  # 128 bytes: int8 q || scale || acc || staging
Q_BASE = packed_q_base(EMB, 8, 1)  # 24: the int8 rows' staging offset
TABLES = {"f32": "unified_emb/embedding", "int8": "unified_q"}  # packed leaf of each trainer
CPU_BATCH, CPU_STEPS = 1024, 2  # card against CPU
LABEL = CategoricalColumnWithIdentity(feature_name="label", category_num=2)
TRAIN_LR = 1e-3
KERNELS = {"f32": (cross_network, segmented_sum_scan, scatter_set_rows),
           "int8": (cross_network, segmented_sum_scan, requantize_rows, scatter_set_rows)}

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# kernel against plain: f32 sums of D terms run in another order
RTOL, ATOL = 1e-4, 1e-6


def close(got: torch.Tensor, want: torch.Tensor, rtol: float = RTOL, atol: float = ATOL) -> float:
    """Max abs error; raises if any element is outside atol + rtol*|want|."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"mismatch: {int(bad.sum())} of {got.numel()} elements outside "
                             f"rtol={rtol} atol={atol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cross_inputs(rng: np.random.Generator, batch: int, dim: int, device):
    """x0 laid out as on the serving path: embeddings ~ N(0, 0.01) then
    N_DENSE dense values ~ N(0, 1); weights as initialised, N(0, 0.01)."""
    x0 = rng.normal(0.0, 0.01, (batch, dim)).astype(np.float32)
    x0[:, -min(N_DENSE, dim):] = rng.normal(size=(batch, min(N_DENSE, dim)))
    ws = rng.normal(0.0, 0.01, (CROSS_LAYERS, dim, dim)).astype(np.float32)
    bs = rng.normal(0.0, 0.01, (CROSS_LAYERS, dim)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x0, ws, bs)]


def check_cross(rng: np.random.Generator) -> float:
    """Phase 3: kernel against plain at every shape serving gives it, plus an
    odd width; returns the max abs error at D=429."""
    worst = 0.0
    shapes = [(b, DIM) for b in (*REQUEST_ROWS, CANDIDATES[0] * CANDIDATES[1])] + [(1000, 37)]
    for batch, dim in shapes:
        x0, ws, bs = cross_inputs(rng, batch, dim, "cuda")
        got = cross_network(x0, ws, bs)
        want = cross_network_plain(x0, ws, bs)
        torch.cuda.synchronize()
        err = close(got, want)
        print(f"cross_network kernel vs plain  B={batch:6d} D={dim} L={CROSS_LAYERS}: "
              f"max abs err {err:.3e}")
        if dim == DIM:
            worst = max(worst, err)
    return worst


def flax_leaves(rng: np.random.Generator, table: str) -> dict:
    """Random DCN-v2 parameters in the flax leaf layout (``/``-joined paths),
    N(0, 0.01) as the JAX package initialises them."""
    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(0.01))

    leaves = {
        "cross/ws": normal(CROSS_LAYERS, DIM, DIM),
        "cross/bs": normal(CROSS_LAYERS, DIM),
        "deep/Dense_0/Dense_0/kernel": normal(DIM, MLP_UNITS[0]),
        "deep/Dense_0/Dense_0/bias": normal(MLP_UNITS[0]),
        "deep/Dense_1/Dense_0/kernel": normal(MLP_UNITS[0], MLP_UNITS[1]),
        "deep/Dense_1/Dense_0/bias": normal(MLP_UNITS[1]),
        "head/kernel": normal(DIM + MLP_UNITS[1], 1),
        "head/bias": normal(1),
        # created by every DCN-v2 tree, never read; the converter drops them
        "bias": np.zeros((), np.float32),
        "dense_factors": normal(N_DENSE, EMB),
        "dense_linear": normal(N_DENSE),
    }
    rows = normal(N_SPARSE * VOCAB, EMB)
    if table == "f32":
        # SparseEmbeddingTrainer(packed_tables=True): [V, 64] table||m||v||pad
        packed = np.zeros((rows.shape[0], 64), np.float32)
        packed[:, :EMB] = rows
        leaves["unified_emb/embedding"] = packed
    else:
        # QuantizedEmbeddingTrainer(packed_tables=True): q||scale||acc||pad u8 rows
        absmax = np.abs(rows).max(axis=1)
        scale = np.where(absmax > 0, absmax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
        q = np.clip(np.rint(rows / scale[:, None]), -127, 127).astype(np.int8)
        width = packed_q_width(EMB, 8, 1)
        packed = np.zeros((rows.shape[0], width), np.uint8)
        packed[:, :EMB] = q.view(np.uint8)
        packed[:, EMB:EMB + 4] = scale[:, None].view(np.uint8)
        leaves["unified_q"] = packed
    return leaves


def make_model(table: str, device, seed: int) -> DCNv2:
    sparse = [CategoricalColumnWithIdentity(feature_name=f"c_{i}", category_num=VOCAB)
              for i in range(N_SPARSE)]
    dense = [NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)]
    quantized = table == "int8"
    return DCNv2(sparse_columns=sparse, dense_columns=dense, label_column=LABEL, emb_size=EMB,
                 num_cross_layers=CROSS_LAYERS, layers=MLP_UNITS, unified_embedding=True,
                 quantized_embedding=quantized, table_packed=quantized, device=device,
                 generator=torch.Generator(device=device).manual_seed(seed))


def make_requests(rng: np.random.Generator) -> list:
    """Host (numpy) requests as a server receives them; no label column."""
    requests = []
    for rows in REQUEST_ROWS:
        req = {f"c_{i}": rng.integers(0, VOCAB, rows).astype(np.int32) for i in range(N_SPARSE)}
        req.update({f"d_{i}": rng.normal(size=rows).astype(np.float32) for i in range(N_DENSE)})
        requests.append((f"{rows} rows", req, (rows,)))
    b, n = CANDIDATES
    # item-side fields per candidate [B, N]; user-side fields [B], broadcast
    req = {f"c_{i}": rng.integers(0, VOCAB, (b, n) if i < N_SPARSE // 2 else b).astype(np.int32)
           for i in range(N_SPARSE)}
    req.update({f"d_{i}": rng.normal(size=b).astype(np.float32) for i in range(N_DENSE)})
    requests.append((f"candidates {b}x{n}", req, (b, n)))
    return requests


class PlainCross(torch.nn.Module):
    """The model's cross network with the plain version in place of the
    kernel (same parameters), for the reference scores."""

    def __init__(self, cross):
        super().__init__()
        self.inner = cross

    def forward(self, x0):
        flat = x0.reshape(-1, self.inner.dim)
        return cross_network_plain(flat, self.inner.ws, self.inner.bs).reshape(x0.shape)


def profile_call(fn, label: str, kernels=(cross_network,), top: int = 6) -> None:
    """Where one call's time goes: torch.profiler's device time by kernel or
    copy, against the call's host-clocked wall time. Each of ``kernels`` must
    launch once."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = [k.launches for k in kernels]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    for kernel, count in zip(kernels, before):
        if kernel.launches != count + 1:
            raise AssertionError(f"{label}: profiled call launched {kernel.__name__} "
                                 f"{kernel.launches - count} times, want 1")
    # the device's own events (kernels, copies); CPU ops repeat their kernels' time
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"{label} profile: no device time recorded (not measured); wall {wall_ms:.3f} ms")
        return
    print(f"{label} profile: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f}%)")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in ranked[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<3d} {e.key[:90]}")
    if ranked[top:]:
        rest = ranked[top:]
        print(f"    {sum(e.self_device_time_total for e in rest) / 1e3:8.3f} ms  "
              f"x{sum(e.count for e in rest):<3d} the {len(rest)} other kinds")


def serve_table(table: str, requests: list, seed: int) -> None:
    """Phase 4 for one table format."""
    rng = np.random.default_rng(seed + (1 if table == "f32" else 2))
    leaves = flax_leaves(rng, table)
    model = params_from_jax(leaves, make_model(table, "cuda", seed))
    serve = Trainer(model).make_serving_fn()
    table_mb = (model.unified_emb.embedding if table == "f32" else model.unified_q).nbytes / 1e6
    print(f"[{table}] table {table_mb:.1f} MB on the card")

    for _, req, _ in requests:  # warm-up: cuBLAS handles and heuristics
        before = cross_network.launches
        serve(req)
        torch.cuda.synchronize()
        if cross_network.launches != before + 1:
            raise AssertionError(f"[{table}] warm-up request launched the cross kernel "
                                 f"{cross_network.launches - before} times")

    scores = {}
    for name, req, shape in requests:
        times = []
        for _ in range(REPEATS):
            before = cross_network.launches
            t0 = time.perf_counter()
            out = serve(req)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if cross_network.launches != before + 1:
                raise AssertionError(f"[{table}] {name}: cross kernel launched "
                                     f"{cross_network.launches - before} times, want 1")
        if tuple(out.shape) != shape or not torch.isfinite(out).all():
            raise AssertionError(f"[{table}] {name}: scores {tuple(out.shape)}, want {shape}, "
                                 f"finite={bool(torch.isfinite(out).all())}")
        scores[name] = out
        ms = 1e3 * float(np.median(times))
        examples = int(np.prod(shape))
        print(f"[{table}] {name:18s} median {ms:8.3f} ms  min {1e3 * min(times):8.3f} ms  "
              f"{examples / (ms / 1e3):12.0f} ex/s  (host clock, {REPEATS} requests)")

    for name, req, shape in requests:
        if shape in PROFILED_SHAPES:
            profile_call(lambda: serve(req), f"[{table}] {name}")

    kernel_cross = model.cross
    model.cross = PlainCross(kernel_cross)
    for name, req, _ in requests:
        err = close(scores[name], serve(req))
        print(f"[{table}] {name:18s} kernel vs plain cross on the card: max abs err {err:.3e}")
    model.cross = kernel_cross

    cpu_model = params_from_jax(leaves, make_model(table, "cpu", seed))
    name, req, _ = requests[1]
    want = Trainer(cpu_model, device="cpu").make_serving_fn()(req)
    err = close(scores[name].cpu(), want)
    print(f"[{table}] {name:18s} card vs CPU (plain) port: max abs err {err:.3e}")


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cross(rng: np.random.Generator, batch: int) -> dict:
    """Phase 5 at one request size: kernel, plain version and a cuBLAS
    yardstick (CUDA events, median of 3 interleaved rounds), and the bound."""
    x0, ws, bs = cross_inputs(rng, batch, DIM, "cuda")

    def library():  # cuBLAS yardstick, never called by the port
        xl = x0
        for layer in range(CROSS_LAYERS):
            xl = torch.addcmul(xl, x0, torch.addmm(bs[layer], xl, ws[layer]))
        return xl

    close(library(), cross_network_plain(x0, ws, bs))
    runs = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(3):
        runs["ms"].append(time_cuda(lambda: cross_network(x0, ws, bs)))
        runs["plain_ms"].append(time_cuda(lambda: cross_network_plain(x0, ws, bs)))
        runs["library_ms"].append(time_cuda(library))
    flops = 2 * batch * DIM * DIM * CROSS_LAYERS + 3 * batch * DIM * CROSS_LAYERS
    nbytes = 4 * (2 * batch * DIM + CROSS_LAYERS * DIM * DIM + CROSS_LAYERS * DIM)
    ops_ms, bytes_ms = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    timing = {k: float(np.median(v)) for k, v in runs.items()}
    timing["bound_ms"] = max(ops_ms, bytes_ms)
    timing["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"cross_network at B={batch}: kernel {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, addmm loop {timing['library_ms']:.4f} ms, bound "
          f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}); rounds {runs}")
    return timing


def make_train_batch(rng: np.random.Generator, rows: int = TRAIN_BATCH) -> dict:
    """``bench.py``'s ``make_host_batch`` at ``rows`` rows."""
    batch = {f"c_{i}": rng.integers(0, VOCAB, size=rows).astype(np.int32)
             for i in range(N_SPARSE)}
    for i in range(N_DENSE):
        batch[f"d_{i}"] = rng.normal(size=rows).astype(np.float32)
    batch["label"] = rng.integers(0, 2, size=rows).astype(np.int32)
    return batch


def unified_ids(fields: dict) -> np.ndarray:
    """Ids in the unified table, row after row, as the trainer flattens them."""
    return np.stack([fields[f"c_{i}"].astype(np.int64) + i * VOCAB for i in range(N_SPARSE)],
                    axis=1).reshape(-1)


def segments(ids: np.ndarray):
    """(sorted ids, is_start, is_last) as the packed update derives them."""
    ordered = np.sort(ids)
    differs = ordered[1:] != ordered[:-1]
    return ordered, np.concatenate([[True], differs]), np.concatenate([differs, [True]])


def scan_input(ids: np.ndarray, gen: torch.Generator, table: str = "f32"):
    """The update's scan operands for these ids: grads N(0, 1) in the staging
    columns of the permuted rows, a strided slice as on the path (f32: floats
    [48, 64) of 64; int8: floats [6, 22) of the 32 that a 128-byte row
    holds), and the heads of the sorted ids."""
    _, heads, _ = segments(ids)
    width, start = (PACKED_W, 3 * EMB) if table == "f32" else (Q_W // 4, Q_BASE // 4)
    wide = torch.randn((ids.shape[0], width), device="cuda", generator=gen)
    return wide[:, start:start + EMB], torch.from_numpy(heads).cuda()


def check_seg_scan(rng: np.random.Generator, gen: torch.Generator):
    """Phase 6, scan: kernel against plain at the main-path shape, with Zipf
    skew and at 1 and 1000 rows; returns the main-path error and inputs."""
    main_ids = unified_ids(make_train_batch(rng))
    # per-field Zipf(2) ids: each field's hottest id fills ~20k rows
    hot = {f"c_{i}": np.minimum(rng.zipf(2.0, TRAIN_BATCH), VOCAB) - 1 for i in range(N_SPARSE)}
    cases = [("bench ids", main_ids, 1e-5), ("zipf(2) ids", unified_ids(hot), 1e-4),
             ("1 row", main_ids[:1], 1e-5), ("1000 rows", main_ids[:1000], 1e-5)]
    main = None
    for name, ids, atol in cases:
        x, heads = scan_input(ids, gen)
        got = segmented_sum_scan(x, heads)
        want = segmented_sum_scan_plain(x, heads)
        torch.cuda.synchronize()
        err = close(got, want, rtol=1e-5, atol=atol)
        longest = int(np.max(np.diff(np.flatnonzero(np.append(segments(ids)[1], True)))))
        print(f"segmented_sum_scan kernel vs plain  {name:12s} n={ids.shape[0]:7d} E={EMB} "
              f"longest segment {longest:6d}: max abs err {err:.3e} (atol {atol})")
        if main is None:
            main = (err, x, heads)
    return main


def time_seg_scan(x: torch.Tensor, heads: torch.Tensor) -> dict:
    """Kernel and plain version (CUDA events, median of 3 interleaved rounds)
    and the bound: read x and the flags once, write the result once."""
    runs = {"ms": [], "plain_ms": []}
    for _ in range(3):
        runs["ms"].append(time_cuda(lambda: segmented_sum_scan(x, heads)))
        runs["plain_ms"].append(time_cuda(lambda: segmented_sum_scan_plain(x, heads), iters=10))
    n, e = x.shape
    nbytes = 2 * n * e * 4 + n
    ops_ms, bytes_ms = 1e3 * n * e / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    timing = {k: float(np.median(v)) for k, v in runs.items()}
    timing.update(library_ms=None, bound_ms=max(ops_ms, bytes_ms),
                  bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    print(f"segmented_sum_scan at n={n} E={e} row stride {x.stride(0)}: kernel "
          f"{timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({nbytes / 1e6:.1f} MB); no single PyTorch call computes it; rounds {runs}")
    return timing


def check_and_time_scatter(rng: np.random.Generator, gen: torch.Generator, table_kind: str):
    """Phase 6, scatter: the update's last-of-segment rows into the packed
    table (f32: [2.6M, 64] f32; int8: [2.6M, 128] u8), bit-exact against
    plain; then kernel, plain (which filters the ids inside), ``index_copy_``
    of the surviving rows (filtered beforehand, untimed) and the bound for
    this data."""
    vocab_rows = N_SPARSE * VOCAB
    ordered, _, last = segments(unified_ids(make_train_batch(rng)))
    n = ordered.shape[0]
    safe = torch.from_numpy(np.where(last, ordered, vocab_rows + np.arange(n)).astype(np.int32))
    safe = safe.cuda()
    if table_kind == "f32":
        width, row_bytes = PACKED_W, 4 * PACKED_W
        table = torch.randn((vocab_rows, width), device="cuda", generator=gen)
        rows = torch.randn((n, width), device="cuda", generator=gen)
    else:
        width = row_bytes = Q_W
        table = torch.randint(0, 256, (vocab_rows, width), dtype=torch.uint8, device="cuda",
                              generator=gen)
        rows = torch.randint(0, 256, (n, width), dtype=torch.uint8, device="cuda", generator=gen)
    want = scatter_set_rows_plain(table.clone(), rows, safe)
    scatter_set_rows(table, rows, safe)
    torch.cuda.synchronize()
    if not torch.equal(table, want):
        raise AssertionError("scatter_set_rows kernel differs from its plain version")
    del want
    kept = int(last.sum())
    print(f"scatter_set_rows kernel vs plain  n={n} ({kept} rows kept) into "
          f"[{vocab_rows}, {width}] {table.dtype}: bit-exact")
    keep = safe < vocab_rows
    kept_ids, kept_rows = safe[keep].long(), rows[keep]
    runs = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(3):
        runs["ms"].append(time_cuda(lambda: scatter_set_rows(table, rows, safe)))
        runs["plain_ms"].append(time_cuda(lambda: scatter_set_rows_plain(table, rows, safe)))
        runs["library_ms"].append(time_cuda(lambda: table.index_copy_(0, kept_ids, kept_rows)))
    nbytes = 2 * kept * row_bytes + 4 * n
    timing = {k: float(np.median(v)) for k, v in runs.items()}
    timing.update(bound_ms=1e3 * nbytes / PEAK_BYTES_S, bound_by="bytes")
    print(f"scatter_set_rows at n={n}, {kept} kept rows of {row_bytes} bytes: kernel "
          f"{timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, index_copy_ {timing['library_ms']:.4f} ms, bound "
          f"{timing['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB); rounds {runs}")
    return 0.0, timing


def check_cross_grad(rng: np.random.Generator, gen: torch.Generator) -> float:
    """Phase 6, gradient: dx0, dws, dbs through the Function (kernel forward)
    against autograd through the plain version, on the card, at B=4096; then
    the forward+backward time of both at B=32768."""
    worst = 0.0
    for batch in (4096, TRAIN_BATCH):
        arrays = cross_inputs(rng, batch, DIM, "cuda")
        upstream = torch.randn((batch, DIM), device="cuda", generator=gen)

        def grads(fn):
            leaves = [a.detach().clone().requires_grad_() for a in arrays]
            out = fn(*leaves)
            out.backward(upstream)
            return [t.grad for t in leaves]

        if batch == 4096:
            before = cross_network.launches
            got = grads(cross_network)
            if cross_network.launches != before + 1:
                raise AssertionError("the cross Function did not launch the kernel")
            for name, a, b in zip(("dx0", "dws", "dbs"), got, grads(cross_network_plain)):
                err = close(a, b)
                worst = max(worst, err)
                print(f"cross_network gradient (kernel Function vs plain autograd) B={batch} "
                      f"{name}: max abs err {err:.3e}")
        else:
            kernel_ms = time_cuda(lambda: grads(cross_network), iters=10)
            plain_ms = time_cuda(lambda: grads(cross_network_plain), iters=10)
            print(f"cross_network forward+backward at B={batch}: Function (kernel forward, "
                  f"torch backward) {kernel_ms:.4f} ms, plain autograd {plain_ms:.4f} ms")
    return worst


def requantize_inputs(rng: np.random.Generator, gen: torch.Generator, seed: int):
    """The int8 update's operands of ``requantize_rows`` at the main path's
    shape: a random int8 packed ``[2.6M, 128]`` table (rows N(0, 0.01),
    accumulators U(0, 1e-3)) gathered at ``bench.py``-drawn ids, grads
    N(0, 1e-2) staged into the rows, the rows permuted into id order, the
    grads summed by the scan kernel, and the salt of step 1 for seed
    ``seed``. Returns (moved, g, sorted ids, salt)."""
    vocab_rows = N_SPARSE * VOCAB
    q, scale = quantize_rows(torch.randn((vocab_rows, EMB), device="cuda", generator=gen) * 0.01)
    acc = torch.rand((vocab_rows,), device="cuda", generator=gen) * 1e-3
    table = pack_quantized_table(q, scale, acc, EMB)
    del q, scale, acc
    ids = torch.from_numpy(unified_ids(make_train_batch(rng)).astype(np.int32)).cuda()
    staged = table.index_select(0, ids)
    del table
    dvec = torch.randn((ids.shape[0], EMB), device="cuda", generator=gen) * 1e-2
    staged[:, Q_BASE:Q_BASE + 4 * EMB] = dvec.view(torch.uint8)
    sorted_ids, order = torch.sort(ids, stable=True)
    moved = staged.index_select(0, order)
    heads = torch.cat([torch.ones(1, dtype=torch.bool, device="cuda"),
                       sorted_ids[1:] != sorted_ids[:-1]])
    g = segmented_sum_scan(moved.view(torch.float32)[:, Q_BASE // 4:Q_BASE // 4 + EMB], heads)
    salt = table_rounding_salt(split(prng_key(seed))[1], 1, TABLES["int8"])
    return moved, g, sorted_ids, salt


def rows_agree(got: torch.Tensor, want: torch.Tensor, label: str) -> float:
    """Requantized rows, kernel against plain: scale and accumulator rtol
    3e-7, q bytes identical except on a row whose scale or accumulator
    differs (there by at most one), every byte after the accumulator zero.
    Returns the max abs error of the dequantized rows."""
    (gq, gs, ga), (wq, ws, wa) = (unpack_quantized_table(t, EMB) for t in (got, want))
    close(gs, ws, rtol=3e-7, atol=0.0)
    close(ga, wa, rtol=3e-7, atol=0.0)
    diff = (gq.int() - wq.int()).abs()
    same = (gs == ws) & (ga == wa)
    if int((diff * same[:, None]).max()) or int(diff.max()) > 1 or got[:, EMB + 8:].any():
        raise AssertionError(f"{label}: q bytes differ by up to {int(diff.max())} "
                             f"({int((diff > 0).sum())} of them), or a staging byte is set")
    err = (dequant_packed_rows(got, EMB) - dequant_packed_rows(want, EMB)).abs()
    print(f"requantize_rows kernel vs plain  {label:24s} n={got.shape[0]:7d}: "
          f"{int((diff > 0).sum())} q bytes, {int((gs != ws).sum())} scales, "
          f"{int((ga != wa).sum())} accumulators differ; dequantized max abs err "
          f"{float(err.max()):.3e}")
    return float(err.max())


def check_and_time_requantize(rng: np.random.Generator, gen: torch.Generator, seed: int):
    """Phase 9: kernel against plain at the main-path shape and the edge
    cases, then kernel and plain timed (CUDA events, median of 3 interleaved
    rounds) and the bound. Returns (main-path error, timing)."""
    moved, g, ids, salt = requantize_inputs(rng, gen, seed)
    zero_moved, zero_g = moved[:1000].clone(), g[:1000].clone()
    zero_moved[7, :EMB] = 0
    zero_g[7] = 0.0
    cases = [("bench ids", moved, g, ids, TRAIN_LR), ("1 row", moved[:1], g[:1], ids[:1], TRAIN_LR),
             ("1000 rows", moved[:1000], g[:1000], ids[:1000], TRAIN_LR),
             ("1000 rows, one all zero", zero_moved, zero_g, ids[:1000], TRAIN_LR),
             ("1000 rows, lr 10", moved[:1000], g[:1000], ids[:1000], 10.0)]
    errs = []
    for label, m, gg, ii, lr in cases:
        got = requantize_rows(m, gg, ii, salt, lr, EMB)
        want = requantize_rows_plain(m, gg, ii, salt, lr, EMB)
        torch.cuda.synchronize()
        errs.append(rows_agree(got.cpu(), want.cpu(), label))
        if label.endswith("all zero"):
            _, scale, _ = unpack_quantized_table(got[7:8].cpu(), EMB)
            if float(scale[0]) != 1.0 or got[7, :EMB].any():
                raise AssertionError("an all-zero row did not keep scale 1 and q 0")
        q_new = unpack_quantized_table(got.cpu(), EMB)[0]
        if label.endswith("lr 10") and int(q_new.abs().max()) != 127:
            raise AssertionError("lr 10 did not reach the clip")

    runs = {"ms": [], "plain_ms": []}
    for _ in range(3):
        runs["ms"].append(time_cuda(lambda: requantize_rows(moved, g, ids, salt, TRAIN_LR, EMB)))
        runs["plain_ms"].append(time_cuda(
            lambda: requantize_rows_plain(moved, g, ids, salt, TRAIN_LR, EMB), iters=10))
    n = moved.shape[0]
    # what the function needs: q || scale || acc, grads and id of each row, the new row
    nbytes = n * ((EMB + 8) + 4 * EMB + 4 + Q_W)
    whole_rows = n * (Q_W + 4 * EMB + 4 + Q_W)
    timing = {k: float(np.median(v)) for k, v in runs.items()}
    timing.update(library_ms=None, bound_ms=1e3 * nbytes / PEAK_BYTES_S, bound_by="bytes")
    print(f"requantize_rows at n={n} W={Q_W} E={EMB}: kernel {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} "
          f"MB; reading whole rows {whole_rows / 1e6:.1f} MB, "
          f"{1e3 * whole_rows / PEAK_BYTES_S:.4f} ms); no single PyTorch call computes it; "
          f"rounds {runs}")
    return errs[0], timing


def make_trainer(table: str, device: str, leaves: dict, sample: dict, seed: int):
    """bench.py's training set-up for ``table``: f32, packed ``table || m || v``
    rows under lazy Adam (``SparseEmbeddingTrainer``); int8, packed
    ``q || scale || acc`` rows under rowwise Adagrad with stochastic
    requantization (``QuantizedEmbeddingTrainer``). Dense Adam, BCE, lr
    1e-3; weights from ``leaves`` (flax layout)."""
    model = make_model(table, device, seed)
    cls = SparseEmbeddingTrainer if table == "f32" else QuantizedEmbeddingTrainer
    trainer = cls(model, device=device, packed_tables=True)
    trainer.compile(optimizer="adam", lr=TRAIN_LR, loss="bce")
    trainer.init_state(sample, seed=seed)
    return params_from_jax(leaves, trainer)


def train(table: str, leaves: dict, rng: np.random.Generator, seed: int):
    """Phases 7 and 10: one main training path, launch counts from zero.
    Returns the launches and the ms/step."""
    tag, path, kernels = f"[train {table}]", TABLES[table], KERNELS[table]
    host = [make_train_batch(rng) for _ in range(4)]
    trainer = make_trainer(table, "cuda", leaves, host[0], seed)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in host]
    packed = trainer.state.packed[path]
    address = packed.data_ptr()
    print(f"{tag} packed table {tuple(packed.shape)} {packed.dtype}, "
          f"{packed.nbytes / 1e6:.1f} MB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def check_buffer():
        if trainer.state.packed[path].data_ptr() != address:
            raise AssertionError(f"{tag} the packed table was reallocated")
        if table == "int8" and trainer.model.unified_q.data_ptr() != address:
            raise AssertionError(f"{tag} the packed table is not the model's unified_q")

    for kernel in kernels:
        kernel.launches = 0
    losses = []
    for step in range(TRAIN_WARMUP + TRAIN_TIMED):
        if step == TRAIN_WARMUP:
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
        losses.append(trainer.train_step(batches[step % len(batches)]))
    end.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED
    launches = {k.__name__: k.launches for k in kernels}
    steps = TRAIN_WARMUP + TRAIN_TIMED
    if any(count != steps for count in launches.values()):
        raise AssertionError(f"{tag} {steps} train steps launched {launches}; want {steps} each")
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{tag} non-finite losses {losses.tolist()}")
    check_buffer()
    ms = start.elapsed_time(end) / TRAIN_TIMED
    print(f"{tag} {steps} train_steps, launches {launches}; losses {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}")
    print(f"{tag} {ms:.3f} ms/step (CUDA events over {TRAIN_TIMED} steps), "
          f"{TRAIN_BATCH / (ms / 1e3):.0f} examples/s; host clock {host_ms:.3f} ms/step")
    print(f"{tag} peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    before = [k.launches for k in kernels]
    history = trainer.fit_steps(iter(batches), steps=4, log_every=2)
    fit_launches = [k.launches - b for k, b in zip(kernels, before)]
    if fit_launches != [4] * len(kernels) or len(history.history["loss"]) != 2 or \
            not np.isfinite(history.history["loss"]).all():
        raise AssertionError(f"{tag} fit_steps: history {history.history}, launches "
                             f"{fit_launches}")
    print(f"{tag} fit_steps(4, log_every=2): loss {history.history['loss']}")
    profile_call(lambda: trainer.train_step(batches[0]), f"{tag} one step", kernels, top=24)
    check_buffer()

    before = cross_network.launches
    request = {k: v[:1000] for k, v in host[1].items() if k != "label"}
    scores = trainer.make_serving_fn()(request)
    torch.cuda.synchronize()
    if tuple(scores.shape) != (1000,) or not torch.isfinite(scores).all() or \
            cross_network.launches != before + 1:
        raise AssertionError(f"{tag} serving from the trained state failed")
    print(f"{tag} make_serving_fn on the trained state: 1000 finite scores, mean "
          f"{float(scores.mean()):.6f}")
    if table == "int8":
        touched = torch.from_numpy(np.unique(np.concatenate([unified_ids(b) for b in host])))
        _, _, acc = trainer.unpacked_quantized()["unified"]
        if not bool((acc[touched] > 0).all()) or acc.numel() != N_SPARSE * VOCAB:
            raise AssertionError(f"{tag} unpacked_quantized: an accumulator of a touched row "
                                 f"stayed 0")
        print(f"{tag} unpacked_quantized: acc > 0 on all {touched.shape[0]} touched rows, "
              f"{int((acc > 0).sum())} of {acc.numel()} rows")
    return {k.__name__: k.launches for k in kernels}, ms


def card_against_cpu(table: str, leaves: dict, rng: np.random.Generator, seed: int) -> None:
    """Phases 8 and 11: 2 steps at batch 1024 on the card and on the CPU
    (plain versions) from the same state: losses rtol 1e-5, dense parameters
    rtol 1e-4 / atol 1e-6; the touched packed rows rtol 1e-4 / atol 1e-6 (f32),
    or their scale and accumulator so and their q values off by at most one
    in at most 0.1% of them (int8: f32 sums in another order move a value
    over a rounding threshold)."""
    path = TABLES[table]
    key = path.replace("/", ".")
    host = [make_train_batch(rng, CPU_BATCH) for _ in range(CPU_STEPS)]
    touched = torch.from_numpy(np.unique(np.concatenate([unified_ids(b) for b in host])))
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = make_trainer(table, device, leaves, host[0], seed)
        losses = torch.stack([trainer.train_step(b) for b in host]).cpu()
        dense = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items() if k != key}
        runs[device] = losses, dense, trainer.state.packed[path][touched.to(device)].cpu()
        del trainer
    (card_loss, card_dense, card_rows), (cpu_loss, cpu_dense, cpu_rows) = runs["cuda"], runs["cpu"]
    errs = [close(card_loss, cpu_loss, rtol=1e-5, atol=0.0)]
    errs += [close(card_dense[k], cpu_dense[k]) for k in cpu_dense]
    if table == "f32":
        errs.append(close(card_rows, cpu_rows))
        rows_note = f"{errs[-1]:.3e}"
    else:
        (cq, cs, ca), (pq, ps, pa) = (unpack_quantized_table(r, EMB) for r in (card_rows, cpu_rows))
        errs.append(max(close(cs, ps), close(ca, pa)))
        diff = (cq.int() - pq.int()).abs()
        flips = int((diff > 0).sum())
        if int(diff.max()) > 1 or flips > max(1, diff.numel() // 1000):
            raise AssertionError(f"int8 card vs CPU: {flips} q values differ, by up to "
                                 f"{int(diff.max())}")
        rows_note = f"scale/acc {errs[-1]:.3e}, {flips} of {diff.numel()} q values off by one"
    print(f"[{table}] card vs CPU, {CPU_STEPS} steps at batch {CPU_BATCH}: losses "
          f"{card_loss.tolist()} / {cpu_loss.tolist()}; max abs err: loss {errs[0]:.3e}, dense "
          f"params {max(errs[1:-1]):.3e}, {touched.shape[0]} touched packed rows {rows_note}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 throughout, as the reference
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)

    # 1. card
    print(card_line())
    kind = torch.cuda.get_device_name(0)
    print(f"torch device 0: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    paths = build("cross", "seg_scan", "scatter", "requantize")
    print(f"built {', '.join(str(p.name) for p in paths.values())} in {time.perf_counter() - t0:.1f} s")

    # 3. kernel against plain (these launches are not the main path's)
    max_err = check_cross(rng)

    # 4. serving: the serving path, with launch counts from zero
    requests = make_requests(rng)
    torch.cuda.reset_peak_memory_stats()
    cross_network.launches = 0
    for table in ("f32", "int8"):
        serve_table(table, requests, args.seed)
    serving_launches = cross_network.launches
    served = 2 * ((1 + REPEATS) * len(requests) + len(PROFILED_SHAPES))
    if serving_launches != served:
        raise AssertionError(f"cross kernel launched {serving_launches} times for {served} "
                             f"requests")
    print(f"serving: {served} requests, cross_network launches {serving_launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # 5. cross timings at the smallest and a middle request; the largest,
    # the training batch, goes into the kernels line
    for batch in (REQUEST_ROWS[0], REQUEST_ROWS[2]):
        time_cross(rng, batch)
    cross_timing = time_cross(rng, TRAIN_BATCH)

    # 6. training kernels against plain, and their times at the f32 and the
    # int8 step's shapes (not the main path's launches)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    scan_err, scan_x, scan_heads = check_seg_scan(rng, gen)
    scan_timing = time_seg_scan(scan_x, scan_heads)
    scan_x, scan_heads = scan_input(unified_ids(make_train_batch(rng)), gen, "int8")
    err = close(segmented_sum_scan(scan_x, scan_heads),
                segmented_sum_scan_plain(scan_x, scan_heads), rtol=1e-5, atol=1e-5)
    print(f"segmented_sum_scan kernel vs plain  bench ids, int8 rows (row stride "
          f"{scan_x.stride(0)}): max abs err {err:.3e}")
    scan_timing_int8 = time_seg_scan(scan_x, scan_heads)
    del scan_x, scan_heads
    scatter_err, scatter_timing = check_and_time_scatter(rng, gen, "f32")
    _, scatter_timing_int8 = check_and_time_scatter(rng, gen, "int8")
    grad_err = check_cross_grad(rng, gen)
    torch.cuda.empty_cache()

    # 7. f32 training, with launch counts from zero
    leaves = flax_leaves(np.random.default_rng(args.seed + 3), "f32")
    f32_launches, f32_ms = train("f32", leaves, rng, args.seed)
    torch.cuda.empty_cache()

    # 8. f32 card against CPU
    card_against_cpu("f32", leaves, rng, args.seed)
    del leaves

    # 9. the requantize kernel against plain (not the main path's launches)
    requant_err, requant_timing = check_and_time_requantize(rng, gen, args.seed)
    torch.cuda.empty_cache()

    # 10. int8 training, with launch counts from zero
    leaves = flax_leaves(np.random.default_rng(args.seed + 4), "int8")
    launches, int8_ms = train("int8", leaves, rng, args.seed)
    print(f"[train] int8-packed {int8_ms:.3f} ms/step against f32-packed {f32_ms:.3f} ms/step "
          f"({f32_ms / int8_ms:.3f}x)")
    torch.cuda.empty_cache()

    # 11. int8 card against CPU
    card_against_cpu("int8", leaves, rng, args.seed)

    n_scan = TRAIN_BATCH * N_SPARSE
    vocab_rows = N_SPARSE * VOCAB
    entries = [
        {"name": "cross_network", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/cross.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/cross.py:50",
         "launches": launches["cross_network"], "max_abs_err": max_err, **cross_timing,
         "shape": f"B={TRAIN_BATCH} D={DIM} L={CROSS_LAYERS} f32",
         "f32_train_launches": f32_launches["cross_network"],
         "serving_launches": serving_launches, "grad_max_abs_err": grad_err},
        {"name": "segmented_sum_scan", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/seg_scan.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/seg_scan.py:108",
         "launches": launches["segmented_sum_scan"], "max_abs_err": scan_err, **scan_timing,
         "shape": f"n={n_scan} E={EMB} f32, row stride {PACKED_W}",
         "f32_train_launches": f32_launches["segmented_sum_scan"],
         "int8": {"shape": f"n={n_scan} E={EMB} f32, row stride {Q_W // 4}",
                  **scan_timing_int8}},
        {"name": "requantize_rows", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/requantize.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/quantize.py:243",
         "launches": launches["requantize_rows"], "max_abs_err": requant_err, **requant_timing,
         "shape": f"n={n_scan} rows of {Q_W} u8, E={EMB}"},
        {"name": "scatter_set_rows", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/scatter.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/dma_scatter.py:117",
         "launches": launches["scatter_set_rows"], "max_abs_err": scatter_err, **scatter_timing,
         "shape": f"n={n_scan} rows of {PACKED_W} f32 into [{vocab_rows}, {PACKED_W}]",
         "f32_train_launches": f32_launches["scatter_set_rows"],
         "int8": {"shape": f"n={n_scan} rows of {Q_W} u8 into [{vocab_rows}, {Q_W}]",
                  **scatter_timing_int8}},
    ]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
