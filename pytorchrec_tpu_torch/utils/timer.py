"""Wall-clock timer context manager (port of ``pytorchrec_tpu/utils/timer.py``).

It reads the host clock only: around work queued on the card, synchronise
inside the block (or time with CUDA events) to measure the device."""

from __future__ import annotations

import time


class Timer:
    """``with Timer("step"):`` prints elapsed seconds, optionally divided."""

    def __init__(self, name: str = "timer", divided_by: int = 1):
        self.name = name
        self.divided_by = divided_by
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        per = self.elapsed / max(self.divided_by, 1)
        if self.divided_by > 1:
            print(f"[{self.name}] elapsed: {self.elapsed:.4f}s ({per:.4f}s each)")
        else:
            print(f"[{self.name}] elapsed: {self.elapsed:.4f}s")
        return False
