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

Operators: the scoring kernels (B1 ``cross_network``, B6's forward
``fm_interaction``, B5 ``din_attention_pool``) are ``torch.library`` ops of
the ``pytorchrec`` namespace (``define_op``): the CUDA implementation
launches the kernel, the CPU implementation is the plain version, and the
fake implementation gives the output's shape and dtype, so eager, captured
and ``torch.export``-ed scoring run one op. ``csrc/serving_ops.cpp``
registers the same schemas in C++ for the Python-free server; a Python
process never loads it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional

import torch

NAMESPACE = "pytorchrec"
# the ops' schemas (csrc/serving_ops.cpp registers the same strings)
SCHEMAS = {
    "cross_network": "cross_network(Tensor x0, Tensor ws, Tensor bs) -> Tensor",
    "fm_interaction": "fm_interaction(Tensor v) -> Tensor",
    "din_attention_pool": ("din_attention_pool(Tensor his, Tensor tgt, Tensor valid, "
                           "Tensor[] params, str activation) -> Tensor"),
}
_FRAGMENTS: List[torch.library.Library] = []  # kept alive: dropping one drops its ops

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


def define_op(name: str, cuda: Callable, cpu: Callable, fake: Callable):
    """Register ``pytorchrec::<name>`` with ``SCHEMAS[name]``: ``cuda`` (the
    kernel's launch) for CUDA tensors, ``cpu`` (the plain version) for CPU
    tensors and ``fake`` (shape and dtype) for tracing. Returns the op."""
    fragment = torch.library.Library(NAMESPACE, "FRAGMENT")
    fragment.define(SCHEMAS[name])
    fragment.impl(name, cuda, "CUDA")
    fragment.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=fragment)
    _FRAGMENTS.append(fragment)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def add_tally(tally: Dict[Callable, int]) -> None:
    """Add a captured graph's launches to the counts: once a replay."""
    for wrapper, n in tally.items():
        wrapper.launches += n


__all__ = ["NAMESPACE", "SCHEMAS", "add_tally", "capture_tally", "count_launch", "define_op",
           "launches_kernel"]
