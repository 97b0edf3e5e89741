#!/usr/bin/env python3
"""B2, B8 and the classic int8 steps of the PyTorch/CUDA port, checkout
against checkout, in turns on one card.

    python3 scripts/torch_update_kernels_ab.py [--seed N] [--out DIR] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding the repo (a ``git archive`` of another
commit, or ``.``); list them in the order to run, e.g. ``parent . . parent``.
For each, in a process of its own started in that directory, it runs that
checkout's ``chip_smoke.py`` functions for

- phase 6's scan checks, then B2's time at the f32 update's shape (E=16,
  row stride 64) and the int8 update's (row stride 32);
- phase 12's B2 at the linear table's E=1 and phase 17's at DIN's E=64
  (f32 and int8 rows; the scatter there too);
- phase 27: B8 against plain and timed, the classic update's parts;
- phases 29 and 30: 25 classic int8 training steps of DCN-v2 and of DeepFM
  at batch 32768 (the last 20 timed with CUDA events), with a profiled step;
- B2 over one segment of every row (normal values from the seed) at E=16,
  1, 64 and 300: its time, and how many of 10 calls on the same input give
  other bits than the first;

writes each process's output to ``DIR/ab_<k>_<name>.log`` (``--out``,
default ``ab_logs``) and prints one JSON line per run (``{"checkout",
"run", "card", "scan", "b8", "parts", "dcnv2_classic_ms",
"deepfm_classic_ms"}``) and then their table. Needs one CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as c

seed = int(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
card = c.card_line()
print(card)
c.build("cross", "seg_scan", "scatter", "fm", "quantize", "requantize")
rng = np.random.default_rng(seed)
gen = torch.Generator(device="cuda").manual_seed(seed)
out = {"card": card, "scan": {}}
_, x, heads = c.check_seg_scan(rng, gen)
out["scan"]["e16_stride64"] = c.time_seg_scan(x, heads)
x, heads = c.scan_input(c.unified_ids(c.make_train_batch(rng)), gen, "int8")
out["scan"]["e16_stride32"] = c.time_seg_scan(x, heads)
del x, heads
out["scan"]["e1_stride64"] = c.check_and_time_lin_scan(rng, gen)
din = c.check_and_time_din_update(rng, gen)
out["scan"]["din_f32"], out["scan"]["din_int8"] = din["scan_f32"], din["scan_int8"]
torch.cuda.empty_cache()
_, out["b8"], out["parts"] = c.check_and_time_b8(rng, gen, seed)
torch.cuda.empty_cache()
leaves = c.flax_leaves(np.random.default_rng(seed + 12), "classic")
_, out["dcnv2_classic_ms"], _ = c.train(c.DCNV2_SPEC, "classic", leaves, rng, seed)
del leaves
torch.cuda.empty_cache()
leaves = c.deepfm_leaves(np.random.default_rng(seed + 13), "classic")
_, out["deepfm_classic_ms"], _ = c.train(c.DEEPFM_SPEC, "classic", leaves, rng, seed)
del leaves
torch.cuda.empty_cache()
out["one_segment"] = {}
for e, n in ((16, 851_968), (1, 851_968), (64, 90_112), (300, 20_000)):
    xs = torch.randn((n, e), device="cuda", generator=gen)
    one = torch.zeros((n,), dtype=torch.bool, device="cuda")
    one[0] = True
    first = c.segmented_sum_scan(xs, one)
    differ = sum(not torch.equal(c.segmented_sum_scan(xs, one), first) for _ in range(9))
    out["one_segment"][f"e{e}"] = {
        "n": n, "ms": c.time_cuda(lambda: c.segmented_sum_scan(xs, one), iters=20),
        "calls_differing_of_9": differ,
        "max_abs_err": float((first - c.segmented_sum_scan_plain(xs, one)).abs().max())}
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
    print(f"{'checkout':24s} {'B8 ms':>8s} {'hash ms':>8s} {'update ms':>9s} "
          f"{'B2 E=16':>8s} {'B2 E=1':>8s} {'B2 DIN':>8s} {'DCN-v2':>8s} {'DeepFM':>8s} "
          f"{'1seg E=16':>9s} {'1seg E=1':>9s} {'1seg E=64':>9s} {'1seg E=300':>10s}")
    for r in results:
        one = r["one_segment"]
        print(f"{r['checkout'][-24:]:24s} {r['b8']['ms']:8.4f} {r['parts']['hash_ms']:8.4f} "
              f"{r['parts']['update_ms']:9.4f} {r['scan']['e16_stride64']['ms']:8.4f} "
              f"{r['scan']['e1_stride64']['ms']:8.4f} {r['scan']['din_f32']['ms']:8.4f} "
              f"{r['dcnv2_classic_ms']:8.3f} {r['deepfm_classic_ms']:8.3f} "
              f"{one['e16']['ms']:9.4f} {one['e1']['ms']:9.4f} {one['e64']['ms']:9.4f} "
              f"{one['e300']['ms']:10.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
