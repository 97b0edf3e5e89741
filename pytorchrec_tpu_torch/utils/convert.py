"""Load flax parameters into a port model.

``params_from_jax(flat, model)`` takes the ``/``-joined flax leaves as numpy
arrays (``{"cross/ws": ..., "deep/Dense_0/Dense_0/kernel": ...}``) and loads
them into the port model's state dict:

* dense kernels ``[in, out]`` become ``nn.Linear`` weights ``[out, in]``;
* an embedding leaf wider than the model's E is a packed
  ``table || moments || staging`` row (``SparseEmbeddingTrainer`` with
  ``packed_tables=True``): f32, bf16 (``packed_dtype``; numpy's
  ``ml_dtypes`` bfloat16 read through its uint16 bits, converted to f32
  exactly) or u8 byte rows (``packed_bytes``, the f32 fields' bits); its
  first E table columns are the table;
* the uint8 packed quantized tables ``unified_q`` and the item table
  ``i_q`` (DIN's and TwoTower's), and the classic quantized leaves of a CTR
  model with ``table_packed=False`` (``unified_q`` int8 ``[V, E]`` or
  nibble-packed ``[V, E/2]``, ``unified_scale`` f32 ``[V]`` or ``[V, G]``),
  pass through unchanged, their dtype and shape held to the model's
  buffers, as do DIN's
  attention weights ``attention/w<i>`` and ``attention/b<i>`` (kept
  ``[in, out]``, ``ops/attention.py``);
* the zoo's (FunkSVD, SVD++, NCF, GRU4Rec, SASRec): the u8 packed item
  tables ``implicit_i_q``, ``mf_i_q`` and ``mlp_i_q`` beside ``i_q``, SVD++'s
  scalar ``global_bias``, the masked GRU's ``rnn/w_ih``, ``rnn/w_hh``,
  ``rnn/b_ih`` and ``rnn/b_hh`` (kept ``[in, 3H]``, ``ops/gru.py``), and
  SASRec's blocks, ``block_shared/...`` or ``block_<i>/...``:
  ``{Q,K,W1,W2}/kernel`` (transposed), ``{W1,W2}/bias`` and
  ``LayerNorm_0/{scale,bias}``; their tables (``p_embeddings`` too) and
  ``out/kernel``, ``prediction_head/kernel`` and NCF's ``mlp`` take the
  rules above;
* the value-based RL family's (DQN, DEERS, LSRL and its ablations):
  ``i_embedding/embedding`` (DQN's item table) beside ``i_embeddings``, the
  masked GRUs ``pos_rnn/...`` and ``neg_rnn/...`` beside ``rnn/...``, the
  fuse layer ``fuse/Dense_0/{kernel,bias}`` (a single ``Dense``:
  ``fuse.linear``, transposed), the branch MLPs and ``out``,
  ``prediction`` by the dense rules; a packed RL table leaf loads as the
  other families' do, and into an RL trainer's target network its first E
  columns (the target keeps a ``[V, E]`` table);
* the multi-task family's (SharedBottom, MMoE, PLE, ESMM): the expert
  banks' stacked ``experts/w_<i>`` ``[K, D, H]`` and ``experts/b_<i>``
  ``[K, H]`` (PLE's ``cgc_<lv>/...``) pass through unchanged; the gates
  (``gate_<t>/kernel``, ``gate_<lv>_t<t>/kernel``,
  ``gate_<lv>_shared/kernel``), towers (``tower_<t>``, ``bottom``,
  ``ctr_tower``, ``cvr_tower``: ``<name>/Dense_<i>/Dense_0/...``) and heads
  (``head_<t>``, ``ctr_head``, ``cvr_head``) take the dense rules;
* TwoTower's leaves need no rule of their own: ``u_embeddings/embedding``
  and ``i_embeddings/embedding`` (plain ``[V, E]`` or packed ``[V, 4E]``),
  ``i_q``, the towers ``user_mlp/Dense_<i>/Dense_0/{kernel,bias}`` and
  ``item_mlp/...``, and the projections ``user_proj/{kernel,bias}`` and
  ``item_proj/{kernel,bias}``;
* the linear term's leaves (``bias``, ``dense_linear``, ``dense_factors``,
  ``lin_<field>/embedding``, ``unified_lin/embedding``, plain ``[V, 1]`` or
  packed ``[V, 64]``) load where the model has them; ``bias``,
  ``dense_factors`` and ``dense_linear`` are created by every DCN-v2 tree
  (and ``dense_factors`` by every LR tree) but never read, so where the
  model has no such parameter they are dropped.

Any other leaf the port does not know raises, as does a port parameter that
no leaf fills.

``params_from_jax(flat, trainer)`` loads into a trainer instead
(``SparseEmbeddingTrainer`` or ``QuantizedEmbeddingTrainer``), right after
its ``init_state``: each packed leaf (``unified_emb/embedding``,
``unified_lin/embedding``, DIN's and TwoTower's ``u_embeddings/embedding``
and ``i_embeddings/embedding`` ``[V, W]`` f32, bf16 or u8 byte rows, or
``unified_q`` / ``i_q`` ``[V, W]`` u8)
loads whole into the trainer's packed
buffer, moments, accumulator and staging columns included, in place; the
dense leaves, and a classic quantized table's ``unified_q`` and
``unified_scale`` (the model's buffers, which the trainer updates), load
into the model as above, in place. The classic accumulator
(``state.table_acc``) and an unpacked table's moments
(``state.table_moments``) are train state, not leaves: they stay as
``init_state`` left them, zero. The dense optimizer's state is
then still empty, as optax's ``init`` leaves it.

The way back: ``flax_path(key)`` names a port state-dict key's flax leaf,
``leaves_of(target)`` gives a model's or a trainer's leaves as host copies
keyed by flax path (a packed trainer's packed buffers whole, kernels back
to ``[in, out]``), and ``load_leaves(flat, target)`` loads such leaves, or
JAX's, at any step: every value is copied into the tensor that holds it
(``copy_``), so no tensor is reallocated and a CUDA graph that captured it
reads the loaded values. ``Trainer.save_weights``, ``load_weights`` and the
checkpoints store and read these leaves. A trainer on a mesh gives each
sharded table whole (gathered over its shard's axis, so every rank of the
axis calls ``leaves_of`` together) and loads whole leaves into its rows. A
trainer's leaves the model does not hold (``Trainer._held_leaves``: the
sharded trainer's hot fragments, ``hot_tables/<path>``, JAX's names) are
given and loaded beside the model's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

UNREAD_LEAVES = frozenset({"bias", "dense_factors", "dense_linear"})

# (flax path pattern, port key template, transform)
_RULES = (
    (r"(\w+)/Dense_(\d+)/Dense_0/kernel", r"\1.layers.\2.linear.weight", "transpose"),
    (r"(\w+)/Dense_(\d+)/Dense_0/bias", r"\1.layers.\2.linear.bias", None),
    (r"(\w+)/Dense_0/kernel", r"\1.linear.weight", "transpose"),
    (r"(\w+)/Dense_0/bias", r"\1.linear.bias", None),
    (r"(\w+)/kernel", r"\1.weight", "transpose"),
    (r"(\w+)/bias", r"\1.bias", None),
    (r"(\w+)/embedding", r"\1.embedding", "table_columns"),
    (r"cross/(ws|bs)", r"cross.\1", None),
    (r"attention/([wb]\d+)", r"attention.\1", None),
    (r"(experts|cgc_\d+)/([wb]_\d+)", r"\1.\2", None),
    (r"(block_shared|block_\d+)/(Q|K|W1|W2)/kernel", r"\1.\2.weight", "transpose"),
    (r"(block_shared|block_\d+)/(W1|W2)/bias", r"\1.\2.bias", None),
    (r"(block_shared|block_\d+)/(LayerNorm_0)/(scale|bias)", r"\1.\2.\3", None),
    (r"(rnn|pos_rnn|neg_rnn)/(w_ih|w_hh|b_ih|b_hh)", r"\1.\2", None),
    (r"(unified_q|unified_scale|i_q|implicit_i_q|mf_i_q|mlp_i_q)", r"\1", None),
    (r"(bias|dense_factors|dense_linear|global_bias)", r"\1", None),
)


def _port_key(path: str):
    for pattern, template, transform in _RULES:
        match = re.fullmatch(pattern, path)
        if match:
            return match.expand(template), transform
    raise KeyError(f"no port counterpart for flax leaf {path!r}")


def flax_path(key: str) -> str:
    """The flax leaf path of port state-dict key ``key`` (the inverse of
    the rules above; ``_port_key`` of it gives ``key`` back)."""
    path = re.sub(r"\.layers\.(\d+)\.linear\.", r"/Dense_\1/Dense_0/", key)
    path = re.sub(r"^(\w+)\.linear\.", r"\1/Dense_0/", path)
    path = re.sub(r"[./]weight$", "/kernel", path).replace(".", "/")
    if _port_key(path)[0] != key:
        raise KeyError(f"no flax leaf for port key {key!r}")
    return path


def _packed_of(target) -> Dict[str, torch.Tensor]:
    if isinstance(target, nn.Module):
        return {}
    if target.state is None:
        raise ValueError("a trainer's leaves exist after init_state()")
    return getattr(target.state, "packed", {})


def leaves_of(target) -> Dict[str, torch.Tensor]:
    """Host copies of ``target``'s leaves (a model, or a trainer after
    ``init_state``), keyed by flax path; what ``load_leaves`` loads."""
    model = target if isinstance(target, nn.Module) else target.model
    packed = _packed_of(target)
    out = {}
    for key, value in model.state_dict().items():
        path = flax_path(key)
        if path in packed:
            value = packed[path]  # the model's table is a view of it
        elif _port_key(path)[1] == "transpose":
            value = value.t()
        out[path] = value.detach().to("cpu", memory_format=torch.contiguous_format, copy=True)
    if isinstance(target, nn.Module):
        return out
    for path, value in target._held_leaves().items():  # leaves the model does not hold
        out[path] = value.detach().to("cpu", memory_format=torch.contiguous_format, copy=True)
    # a trainer on a mesh: each sharded table whole (gathered over its shard's axis)
    return target._full_leaves(out)


def _host_tensor(value) -> torch.Tensor:
    """A writable, contiguous CPU copy of a leaf (a tensor or an array). A
    JAX bf16 array comes to numpy as ``ml_dtypes``' bfloat16, which
    ``torch.from_numpy`` refuses: its bits go through uint16."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", memory_format=torch.contiguous_format, copy=True)
    array = np.asarray(value)
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(array.view(np.uint16), order="C")).view(torch.bfloat16)
    return torch.from_numpy(np.array(array, order="C"))


def _table_columns(tensor: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """A table leaf as the model's f32 ``[V, E]`` table: a packed leaf's
    first E columns, of f32 rows, of bf16 rows (converted, exactly) or of
    byte rows (the fields' bits)."""
    if tensor.dim() != 2 or want.dim() != 2 or want.dtype != torch.float32:
        return tensor
    if tensor.dtype == torch.uint8 and tensor.shape[1] % 4 == 0:
        tensor = tensor.view(torch.float32)
    if tensor.shape[1] > want.shape[1]:
        tensor = tensor[:, :want.shape[1]]
    return tensor.to(torch.float32, memory_format=torch.contiguous_format)


def _load_packed(path: str, value, packed: torch.Tensor) -> None:
    tensor = _host_tensor(value)
    if tuple(tensor.shape) != tuple(packed.shape) or tensor.dtype != packed.dtype:
        raise ValueError(f"flax leaf {path!r} is {tuple(tensor.shape)} {tensor.dtype}; the packed "
                         f"buffer is {tuple(packed.shape)} {packed.dtype}")
    with torch.no_grad():
        packed.copy_(tensor)


def params_from_jax(flat: Mapping[str, np.ndarray], target):
    """Load ``flat`` into ``target``, a model (on whatever device it lives)
    or a packed trainer right after its ``init_state``; return ``target``.
    An RL trainer's target network (``state.target``) takes the same
    leaves, as JAX's ``target_params`` start as a copy of the params."""
    if not isinstance(target, nn.Module) and (target.state is None or target.state.step != 0):
        raise ValueError("load into a trainer right after init_state(), before any step")
    load_leaves(flat, target)
    rl_target = getattr(getattr(target, "state", None), "target", None)
    if rl_target is not None:
        load_leaves(flat, rl_target)
    return target


def load_leaves(flat: Mapping[str, Any], target):
    """Load ``flat`` (flax path -> numpy array or tensor) into ``target``, a
    model or a trainer with a state, in place; return ``target``."""
    model = target if isinstance(target, nn.Module) else target.model
    packed = _packed_of(target)
    if not isinstance(target, nn.Module):  # a trainer on a mesh keeps its rows of each table
        flat = dict(target._local_leaves(flat))
        for path, tensor in target._held_leaves().items():
            if path not in flat:
                raise KeyError(f"no flax leaf for {path!r}")
            _load_packed(path, flat.pop(path), tensor)
    state = model.state_dict()
    loaded: Dict[str, torch.Tensor] = {}
    filled = set()
    for path, value in flat.items():
        if path in UNREAD_LEAVES and path not in state:
            continue
        key, transform = _port_key(path)
        if key not in state:
            raise KeyError(f"flax leaf {path!r} maps to {key!r}, which the model lacks")
        if path in packed:
            _load_packed(path, value, packed[path])  # the model's table is a view of it
            filled.add(key)
            continue
        want = state[key]
        tensor = _host_tensor(value)
        if transform == "transpose":
            tensor = tensor.t().contiguous()
        elif transform == "table_columns":
            tensor = _table_columns(tensor, want)
        if tuple(tensor.shape) != tuple(want.shape) or tensor.dtype != want.dtype:
            raise ValueError(f"flax leaf {path!r} is {tuple(tensor.shape)} {tensor.dtype}; "
                             f"{key!r} wants {tuple(want.shape)} {want.dtype}")
        loaded[key] = tensor
    missing = sorted(set(state) - set(loaded) - filled)
    if missing:
        raise KeyError(f"no flax leaf for {missing}")
    model.load_state_dict(loaded, strict=not filled)
    return target
