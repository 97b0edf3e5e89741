"""int8 dense-gradient means with error feedback (port of
``pytorchrec_tpu/parallel/grad_compression.py``).

Each data replica quantizes its gradient leaf to int8 with one f32 scale
(absmax / 127, round half to even), the int8 payloads and the scales ride
an ``all_gather`` (1 byte an element on the wire instead of 4) and every
replica dequantizes and averages locally. The quantization error
``g - dequant(quant(g))`` is kept (the residual, train state) and added to
the next step's gradient, so small persistent components are not dropped.

Per device and payload P bytes, a ring all-reduce of f32 moves about
``2 * 4P (D-1)/D``, the int8 ``all_gather`` receives ``(D-1) P``: the
compressed exchange wins for few participants on a slow axis, which is
where the sharded trainer applies it (the data axis). Float leaves of at
least ``min_size`` elements are compressed; the rest take the plain mean.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple, Union

import torch

from pytorchrec_tpu_torch.parallel.mesh import Mesh

DEFAULT_MIN_SIZE = 1024


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 leaf -> (int8 leaf, f32 0-d scale), absmax scaling."""
    absmax = g.abs().max()
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _is_compressible(leaf: torch.Tensor, min_size: int) -> bool:
    return leaf.is_floating_point() and leaf.numel() >= min_size


def compressed_leaf_pmean(g: torch.Tensor, r: torch.Tensor, mesh: Mesh,
                          axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf's mean over ``axis`` through the int8 wire format, with
    error feedback: ``(mean, new residual)``. Two collectives: the int8
    leaves and the scales."""
    g_fb = g + r
    q, scale = _quantize_leaf(g_fb)
    q_all = mesh.all_gather(q[None], axis)             # [D, ...] int8
    s_all = mesh.all_gather(scale.reshape(1), axis)    # [D] f32
    deq = q_all.to(torch.float32) * s_all.reshape((-1,) + (1,) * q.dim())
    mean = deq.mean(dim=0)
    return mean, g_fb - q.to(torch.float32) * scale


def select_compressible(flat_params: Mapping[str, torch.Tensor], exclude=(), *,
                        min_size: int = DEFAULT_MIN_SIZE) -> Dict[str, torch.Tensor]:
    """Zero residuals for the leaves worth compressing: float, at least
    ``min_size`` elements, not in ``exclude`` (tables keep their own sparse
    exchange and grow no dense residual)."""
    return {path: torch.zeros_like(leaf) for path, leaf in flat_params.items()
            if path not in exclude and _is_compressible(leaf, min_size)}


def compressed_pmean_flat(flat_grads: Mapping[str, torch.Tensor],
                          residuals: Mapping[str, torch.Tensor], mesh: Mesh, axis
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The mean of each grad over ``axis``: the int8 wire format and error
    feedback for the paths in ``residuals``, in the dict's order, then the
    rest's plain mean in one ``all_reduce``. Returns ``(means, new
    residuals)``."""
    out, new_res = {}, {}
    plain = [path for path in flat_grads if path not in residuals]
    for path, g in flat_grads.items():
        if path in residuals:
            out[path], new_res[path] = compressed_leaf_pmean(g, residuals[path], mesh, axis)
    if plain:
        flat = torch.cat([flat_grads[p].reshape(-1) for p in plain])
        mesh.psum(flat, axis)
        flat /= mesh.axis_size(axis)
        at = 0
        for path in plain:
            n = flat_grads[path].numel()
            out[path] = flat[at:at + n].view_as(flat_grads[path])
            at += n
    return {path: out[path] for path in flat_grads}, new_res


def compressed_wire_bytes(grads: Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]],
                          n_devices: int, *, min_size: int = DEFAULT_MIN_SIZE) -> dict:
    """Per-device traffic, analytic: the int8 ``all_gather``'s received
    bytes against a ring all-reduce of f32."""
    leaves = grads.values() if isinstance(grads, Mapping) else grads
    compressed = plain = 0
    for leaf in leaves:
        nbytes_f32 = leaf.numel() * 4
        if _is_compressible(leaf, min_size):
            compressed += leaf.numel() * (n_devices - 1) + 4 * (n_devices - 1)
        else:
            compressed += int(2 * nbytes_f32 * (n_devices - 1) / n_devices)
        plain += int(2 * nbytes_f32 * (n_devices - 1) / n_devices)
    return {"int8_allgather_bytes": compressed, "f32_allreduce_bytes": plain,
            "ratio": compressed / max(plain, 1)}
