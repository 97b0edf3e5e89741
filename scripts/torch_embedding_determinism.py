#!/usr/bin/env python3
"""Whether a table lookup's backward repeats its bits on the card.

    python3 scripts/torch_embedding_determinism.py [--repeats 6]

For three shapes of the zoo's dense tables (SASRec's 51 positions under
4096 x 50 ids, a user table of 65,536 rows under 4096 ids, a 1M-row item
table under 4096 x 52 skewed ids; E=64), each way of looking rows up
(``index_select``, ``F.embedding``, the one-hot product SASRec uses for its
positions, and an ``index_put_(accumulate=True)`` backward) runs forward
and backward ``--repeats`` times on the same ids and gradients: the line
says whether every gradient is bit-equal to the first, and the ms of one
forward and backward (CUDA events over 10). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

E = 64
SHAPES = {"positions": (51, 4096 * 50), "users": (65_536, 4096), "items": (1 << 20, 4096 * 52)}


class _PutAccumulate(torch.autograd.Function):
    """A gather whose backward is ``index_put_(accumulate=True)``."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return torch.index_select(table, 0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows, grad.shape[1]))
        return out.index_put_((ids,), grad, accumulate=True), None


def _one_hot(table, ids):
    rows = torch.arange(table.shape[0], device=ids.device)
    return (ids[:, None] == rows).to(table.dtype) @ table


LOOKUPS = {"index_select": lambda table, ids: torch.index_select(table, 0, ids),
           "F.embedding": lambda table, ids: F.embedding(ids, table),
           "one-hot product": _one_hot,
           "index_put_ accumulate": _PutAccumulate.apply}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    print(torch.cuda.get_device_name(0))
    for shape, (rows, n) in SHAPES.items():
        ids = (torch.rand(n, device="cuda") ** 3 * rows).long()
        grad = torch.randn(n, E, device="cuda")
        for name, lookup in LOOKUPS.items():
            if name == "one-hot product" and rows > 4096:
                continue  # a [n, rows] one-hot: for small tables only
            grads = []
            for _ in range(args.repeats):
                table = torch.zeros(rows, E, device="cuda", requires_grad=True)
                lookup(table, ids).backward(grad)
                grads.append(table.grad.clone())
            same = all(torch.equal(grads[0], g) for g in grads[1:])
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            table = torch.zeros(rows, E, device="cuda", requires_grad=True)
            start.record()
            for _ in range(10):
                lookup(table, ids).backward(grad)
            end.record()
            torch.cuda.synchronize()
            print(f"{shape:9s} {rows:8d} rows {n:7d} ids  {name:22s} repeats bit-equal: {same}; "
                  f"forward and backward {start.elapsed_time(end) / 10:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
