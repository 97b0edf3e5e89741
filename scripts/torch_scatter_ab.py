#!/usr/bin/env python3
"""B4 (the row scatter-set) and the captured steps it runs in, checkout
against checkout, in turns on one card.

    python3 scripts/torch_scatter_ab.py [--seed N] [--out DIR] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding the repo (a ``git archive`` of another
commit, or ``.``); list them in the order to run, e.g. ``parent . . parent``.
For each, in a process of its own started in that directory, it runs that
checkout's ``chip_smoke.py`` functions for

- phase 6's B4 at the packed update's shape (256-byte f32 rows and 128-byte
  int8 rows into ``[2.6M, W]``) and phase 17's at DIN's (1 KB and 384-byte
  rows), each beside ``index_copy_``; phase 27's classic update's two
  scatter-sets (16-byte q rows and 4-byte scales) timed together;
- phase 35's captured classic DCN-v2 step (eager against captured, bit for
  bit; captured ms/step and a profiled replay's device ms);
- phase 41's captured DLRM steps with the classic table and with 26
  per-field tables (78 B4 launches a step);

writes each process's output to ``DIR/ab_<k>_<name>.log`` (``--out``,
default ``ab_logs``) and prints one JSON line per run (``{"checkout",
"run", "card", "b4", "dcnv2_classic", "dlrm_classic", "dlrm_per_field"}``)
and then their table. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

RUN = r'''
import gc, json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as c

seed = int(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
card = c.card_line()
print(card)
c.build("cross", "seg_scan", "scatter", "quantize", "requantize")
rng = np.random.default_rng(seed)
gen = torch.Generator(device="cuda").manual_seed(seed)
out = {"card": card, "b4": {}}
for kind, width in (("f32", "256 B"), ("int8", "128 B")):
    _, out["b4"][width] = c.check_and_time_scatter(rng, gen, kind)
din = c.check_and_time_din_update(rng, gen)
out["b4"]["1 KB"], out["b4"]["384 B"] = din["scatter_f32"], din["scatter_int8"]
_, _, parts = c.check_and_time_b8(rng, gen, seed)
out["b4"]["classic pair"] = {"ms": parts["scatters_ms"]}
torch.cuda.empty_cache()
leaves = c.flax_leaves(np.random.default_rng(seed + 21), "classic")
step = c.capture_path(c.DCNV2_SPEC, "classic", leaves, rng, seed)
out["dcnv2_classic"] = {"ms": step["captured_ms"], "device_ms": step["replay_device_ms_per_step"]}
del leaves, step
for offset, table in ((2, "classic"), (3, "per_field")):
    gc.collect()
    torch.cuda.empty_cache()
    leaves = c.dlrm_leaves(np.random.default_rng(seed + 42 + offset), table)
    _, _, step = c.phase41_path(c.DLRM_SPEC, table, leaves, rng, seed, {})
    out[f"dlrm_{table}"] = {"ms": step["ms_per_step"], "device_ms": step["replay_device_ms"]}
    del leaves, step
print("AB " + json.dumps(out))
'''


def run(checkout: Path, k: int, seed: int, out_dir: Path) -> dict:
    log = out_dir / f"ab_{k}_{checkout.resolve().name}.log"
    with open(log, "w") as f:
        proc = subprocess.run([sys.executable, "-c", RUN, str(seed)], cwd=checkout, stdout=f,
                              stderr=subprocess.STDOUT, text=True,
                              env={**os.environ, "PYTHONPATH": str(checkout.resolve())})
    lines = [line for line in log.read_text().splitlines() if line.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"run {k} in {checkout} failed (rc {proc.returncode}); see {log}")
    return {"checkout": str(checkout), "run": k, **json.loads(lines[-1][3:])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkouts", nargs="+", type=Path)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=Path("ab_logs"))
    args = parser.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    results = []
    for k, checkout in enumerate(args.checkouts):
        results.append(run(checkout, k, args.seed, args.out))
        print(json.dumps(results[-1]), flush=True)
    widths = list(results[0]["b4"])
    steps = ("dcnv2_classic", "dlrm_classic", "dlrm_per_field")
    print(f"{'checkout':24s} " + " ".join(f"{w:>12s}" for w in widths)
          + " " + " ".join(f"{s:>26s}" for s in steps) + "   (B4 ms; a step's ms / device ms)")
    for r in results:
        cells = [f"{r['b4'][w]['ms']:12.4f}" for w in widths]
        for s in steps:
            ms = r[s]["ms"] if isinstance(r[s]["ms"], list) else [r[s]["ms"]]
            cells.append(f"{'/'.join(f'{x:.3f}' for x in ms):>16s} / {r[s]['device_ms']:7.3f}")
        print(f"{r['checkout'][-24:]:24s} " + " ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
