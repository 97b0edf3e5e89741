"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Dispatch rule, shared by every kernel wrapper (it replaces the JAX package's
``use_pallas_default``): a CUDA tensor launches the kernel, and a failed
launch raises; a CPU tensor takes the plain version. Nothing else chooses:
no environment variable, no ``try`` that falls back.
"""

from __future__ import annotations

import torch


def launches_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (run the plain version)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on one kind of device, got {sorted(kinds)}")


__all__ = ["launches_kernel"]
