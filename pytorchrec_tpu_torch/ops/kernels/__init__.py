"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Dispatch rule, shared by every kernel wrapper (it replaces the JAX package's
``use_pallas_default``): a CUDA tensor launches the kernel, and a failed
launch raises; a CPU tensor takes the plain version. Nothing else chooses:
no environment variable, no ``try`` that falls back.

Launch counts: each wrapper calls ``count_launch(wrapper)`` where it
launches its kernel, which adds one to ``wrapper.launches``. While a CUDA
graph is captured (``capture_tally``) no kernel runs: the launch goes into
the graph's tally instead, and each replay adds the tally
(``add_tally``), so a count reads the same for eager and replayed steps.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional

import torch

# the tally of the graph being captured (one capture at a time, on the
# thread that launches the kernels), or None
_tally: Optional[Dict[Callable, int]] = None


def launches_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (run the plain version)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on one kind of device, got {sorted(kinds)}")


def count_launch(wrapper: Callable) -> None:
    """One launch of ``wrapper``'s kernel: into the tally of the graph being
    captured, else into ``wrapper.launches``."""
    if _tally is not None:
        _tally[wrapper] = _tally.get(wrapper, 0) + 1
    else:
        wrapper.launches += 1


@contextlib.contextmanager
def capture_tally() -> Iterator[Dict[Callable, int]]:
    """The launches made inside, by wrapper, kept out of the counts: the
    tally of a CUDA graph captured inside."""
    global _tally
    if _tally is not None:
        raise RuntimeError("a launch tally is already being recorded")
    _tally = {}
    try:
        yield _tally
    finally:
        _tally = None


def add_tally(tally: Dict[Callable, int]) -> None:
    """Add a captured graph's launches to the counts: once a replay."""
    for wrapper, n in tally.items():
        wrapper.launches += n


__all__ = ["add_tally", "capture_tally", "count_launch", "launches_kernel"]
