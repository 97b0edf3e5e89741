#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorchrec_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Phases; any failure ends the run with a non-zero exit and no result line:

1. card: the card's name and power limit (nvidia-smi) and torch's name for it;
2. build: every CUDA kernel of the serving path, from ``pytorchrec_tpu_torch/csrc``;
3. kernel against plain: each kernel's wrapper on the card at the shapes the
   serving path gives it, held against its plain PyTorch version;
4. serving: DCN-v2 at the full Criteo width (26 sparse fields of 100k ids,
   E=16, 13 dense fields, 3 cross layers, MLP 256-128; ``bench.py``'s
   config), weights made from ``--seed`` in the flax leaf layout and loaded
   through ``params_from_jax``. It scores requests of 1, 1000, 4096 and 32768
   rows and one candidate request [256, 100], once with the f32 table (the
   packed ``table || moments`` leaf) and once with the int8 packed byte-row
   table. Launch counts are zeroed just before and read just after; each
   request must launch each kernel once, give finite scores of the right
   shape and agree with the same model run with the plain cross network on
   the card and, for the 1000-row request, on the CPU. One more 1-row and
   one more 32768-row request run under torch.profiler, which prints the
   device time by kernel and copy against the request's wall time;
5. timings: each kernel's time at 1, 4096 and 32768 rows beside its plain
   version, a cuBLAS yardstick and the card's bound, and a
   ``{"kernels": [...]}`` line with those at the largest shape.

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
from pytorchrec_tpu_torch.ops.quantized_packed import packed_q_width
from pytorchrec_tpu_torch.training import Trainer
from pytorchrec_tpu_torch.utils import params_from_jax

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
    return DCNv2(sparse_columns=sparse, dense_columns=dense, emb_size=EMB,
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


def profile_request(serve, req: dict, label: str, top: int = 6) -> None:
    """Where one request's time goes: torch.profiler's device time by kernel
    or copy, against the request's host-clocked wall time."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = cross_network.launches
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        serve(req)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if cross_network.launches != before + 1:
        raise AssertionError(f"{label}: profiled request launched the cross kernel "
                             f"{cross_network.launches - before} times, want 1")
    # the device's own events (kernels, copies); CPU ops repeat their kernels' time
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"{label} profile: no device time recorded (not measured); wall {wall_ms:.3f} ms")
        return
    print(f"{label} profile: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<3d} {e.key[:90]}")


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
            profile_request(serve, req, f"[{table}] {name}")

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
    paths = build("cross")
    print(f"built {', '.join(str(p.name) for p in paths.values())} in {time.perf_counter() - t0:.1f} s")

    # 3. kernel against plain (these launches are not the main path's)
    max_err = check_cross(rng)

    # 4. serving: the main path, with launch counts from zero
    requests = make_requests(rng)
    torch.cuda.reset_peak_memory_stats()
    cross_network.launches = 0
    for table in ("f32", "int8"):
        serve_table(table, requests, args.seed)
    launches = cross_network.launches
    served = 2 * ((1 + REPEATS) * len(requests) + len(PROFILED_SHAPES))
    if launches != served:
        raise AssertionError(f"cross kernel launched {launches} times for {served} requests")
    print(f"serving: {served} requests, cross_network launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # 5. timings at the smallest, a middle and the largest request; the
    # kernels line reports the largest, the main path's throughput end
    for batch in (REQUEST_ROWS[0], REQUEST_ROWS[2]):
        time_cross(rng, batch)
    batch = REQUEST_ROWS[-1]
    entry = {
        "name": "cross_network",
        "route": "cuda",
        "source": "pytorchrec_tpu_torch/csrc/cross.cu",
        "replaces": "pytorchrec_tpu/ops/kernels/cross.py:50",
        "launches": launches,
        "max_abs_err": max_err,
        **time_cross(rng, batch),
        "shape": f"B={batch} D={DIM} L={CROSS_LAYERS} f32",
    }
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
