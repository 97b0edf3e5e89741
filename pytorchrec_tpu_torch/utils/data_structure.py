"""Nested-structure helpers (port of ``pytorchrec_tpu/utils/data_structure.py``):
the host and device marshalling of batches and logs.

``jax.tree_util.tree_map`` becomes a recursion over dicts, lists and tuples
(a named tuple keeps its type); anything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def map_structure(fn: Callable[[Any], Any], structure: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested list/dict/tuple structure."""
    if isinstance(structure, dict):
        return type(structure)((k, map_structure(fn, v)) for k, v in structure.items())
    if isinstance(structure, tuple) and hasattr(structure, "_fields"):
        return type(structure)(*(map_structure(fn, v) for v in structure))
    if isinstance(structure, (list, tuple)):
        return type(structure)(map_structure(fn, v) for v in structure)
    return fn(structure)


def to_numpy(structure: Any) -> Any:
    """Tensors (on any device) -> host numpy; python scalars pass through."""

    def _leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return map_structure(_leaf, structure)


def to_python_scalars(structure: Any) -> Any:
    """0-d tensors and arrays -> python scalars; other arrays -> numpy."""

    def _leaf(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
            return arr.item() if arr.ndim == 0 else arr
        return x

    return map_structure(_leaf, structure)


def to_device(structure: Any, device) -> Any:
    """Host batch -> ``device``: each numpy array or tensor leaf becomes a
    tensor there (an asynchronous copy); other leaves pass through."""
    device = torch.device(device)

    def _leaf(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return torch.as_tensor(x).to(device, non_blocking=True)
        return x

    return map_structure(_leaf, structure)
