"""Full-corpus top-k retrieval for two-tower models (port of
``pytorchrec_tpu/serving/retrieval.py``).

The serving half of ``models/two_tower.py``: ``build_item_index`` runs every
item id through the item tower once (one ``[V, D]`` matrix on the device,
bf16 by default), and ``make_retrieve_fn`` answers queries against it:

* exact (default): the corpus is scored in chunks of ``chunk_items`` rows
  (one library matrix product each on the card, ``ordered_scores`` on the
  CPU; f32 scores) with a running top-k merge, so at most
  ``B x chunk_items`` scores exist at once;
* ``approx="fused"``: kernel B7 (``ops/kernels/retrieval_topk.py``) scores
  the corpus and keeps 128 bin maxima a super-chunk of ``16 x 2048`` rows
  without writing the scores, then one exact top-k ranks the candidates.
  Every such call launches B7 once on the card;
* ``approx=True`` runs the exact path: the JAX package's
  ``lax.approx_max_k`` is a TPU partial reduction with no counterpart here
  (on the CPU JAX returns the exact top-k too), and ``recall_target`` is
  accepted and unused.

Every top-k puts equal scores at the lower column first, as ``lax.top_k``
does (``top_k``). Returned ids are int32, as in JAX.

Corpus-sharded retrieval over a mesh (``parallel/mesh.py``; every rank makes
the same calls): ``shard_item_index`` pads the index with zero rows to a
multiple of the corpus shards and keeps this rank's rows, and
``make_sharded_retrieve_fn`` scores each rank's slice of the queries
against its shard (B7 in fused mode, the exact chunked path otherwise, the
pad rows masked by global id), gathers the ``[B_local, k]`` candidates over
the corpus axes and ranks them with one exact top-k, then gathers the
query slices: every rank returns the whole batch's ``(scores, ids)``. It
runs eagerly (a gloo world cannot be captured).

JAX jits the user tower and ``_fused_topk`` / ``_topk_scores`` with ``k``
static. The port's twin is one CUDA graph per ``(item_index, B, k)``
(``utils/graphs.py``): the user tower, then B7, the temperature, the pad-bin
mask and the top-k (or the exact chunked path), over a static buffer of the
query ids. The first call of a key runs eagerly, the second captures, later
ones replay; the scores and ids are copied out. A graph reads the index
tensor it was captured with and keeps it alive (``retrieve.graphs.clear()``
lets it go); another index tensor gets graphs of its own.
``retrieve.eager(item_index, u_ids, k)`` runs the same calls eagerly.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from pytorchrec_tpu_torch.ops.kernels.retrieval_topk import bin_max_scores, ordered_scores
from pytorchrec_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from pytorchrec_tpu_torch.utils.graphs import GraphCache, StaticInputs

Retrieve = Callable[[torch.Tensor, object, int], Tuple[torch.Tensor, torch.Tensor]]


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last dimension: the k largest values in
    descending order and their columns, equal values at the lower column
    first. ``torch.topk`` promises no order among ties, so it runs on int64
    keys that are unique: the value's bits mapped to an integer of the same
    order (``-0.0`` below ``0.0``, as JAX orders them), then the column,
    reversed."""
    n = values.shape[-1]
    if k > n:
        raise ValueError(f"k={k} is larger than the {n} values to choose from")
    bits = values.float().contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    column = torch.arange(n, device=values.device, dtype=torch.int64)
    keys = ordered * 2**32 + (2**32 - 1 - column)
    sel = torch.topk(keys, k, dim=-1).indices
    return torch.gather(values, -1, sel), sel


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def build_item_index(model, num_items: int, batch_size: int = 65536,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Every item id through the item tower -> ``[num_items, D]`` on the
    model's device, cast to ``dtype`` (bf16 by default, as in JAX: half the
    memory, and B7's tensor-core products). Batches of ``batch_size`` ids
    (the last one wrapped around to the start) bound the tower's
    activations."""
    device = _device_of(model)
    padded = -(-num_items // batch_size) * batch_size
    ids = torch.arange(padded, dtype=torch.int32, device=device) % max(num_items, 1)
    with torch.inference_mode():
        parts = [model.item_vectors(ids[start:start + batch_size])
                 for start in range(0, padded, batch_size)]
        return torch.cat(parts)[:num_items].to(dtype)


def make_retrieve_fn(model, temperature: Optional[float] = None, chunk_items: int = 65536,
                     approx=False, recall_target: float = 0.99,
                     fused_group: int = 16) -> Retrieve:
    """``retrieve(item_index, u_ids, k) -> (scores [B, k] f32, item_ids [B, k]
    int32)``, scores in descending order. The model holds its parameters, so
    there is no ``params`` argument (JAX's first). When the model is
    cosine-normalized the scores are divided by its temperature (or by
    ``temperature``), so they match training logits.

    ``approx``: False or True, the exact chunked path (see the module
    docstring for True); ``"fused"``, B7's bin maxima over super-chunks of
    ``fused_group`` chunks of 2048 rows, then an exact top-k over them.
    ``fused_group`` trades recall (about ``1 - (k - 1) / (2 n_bins)``) for
    speed."""
    scale = temperature if temperature is not None else (
        model.temperature if model.normalize else None)
    device = _device_of(model)
    graphs = GraphCache(device)

    def scores(item_index, u_ids, k):
        u_vec = model.user_vectors(u_ids)
        if approx == "fused":
            return _fused_topk(u_vec, item_index, k, scale, fused_group)
        return _topk_scores(u_vec, item_index, k, scale, chunk_items)

    def inputs(item_index, shape, k) -> StaticInputs:
        ids = StaticInputs([torch.zeros(shape, dtype=torch.int64, device=device)],
                           lambda u_ids, out: out[0].copy_(u_ids))
        ids.index, ids.k = item_index, k  # the graph holds the index alive
        return ids

    def retrieve(item_index, u_ids, k):
        u_ids = torch.as_tensor(u_ids)
        key = (id(item_index), tuple(u_ids.shape), int(k))
        return graphs.run(key, lambda ids: ids.load(u_ids, (u_ids,)),
                          lambda: inputs(item_index, u_ids.shape, int(k)),
                          lambda ids: scores(ids.index, ids.buffers[0], ids.k))

    def eager(item_index, u_ids, k):
        with torch.inference_mode():
            return scores(item_index, torch.as_tensor(u_ids).to(device), k)

    retrieve.eager, retrieve.graphs = eager, graphs
    return retrieve


def _mesh_axes(corpus_axis) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(the corpus axes, the query axes: the mesh's others, in its order)."""
    corpus = (corpus_axis,) if isinstance(corpus_axis, str) else tuple(corpus_axis)
    if not corpus or not set(corpus) <= {DATA_AXIS, MODEL_AXIS} or len(set(corpus)) < len(corpus):
        raise ValueError(f"corpus_axis must name mesh axes, got {corpus_axis!r}")
    return corpus, tuple(a for a in (DATA_AXIS, MODEL_AXIS) if a not in corpus)


def _place(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(how many slices ``axes`` make, this rank's slice), row-major over
    ``axes`` as a gather over them orders its parts."""
    size, index = 1, 0
    for axis in axes:
        n = mesh.axis_size(axis)
        size, index = size * n, index * n + mesh.axis_index(axis)
    return size, index


def _gather(mesh: Mesh, tensor: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """``[n, ...]``: ``tensor`` of each rank along ``axes``, in index order."""
    if not axes:
        return tensor[None]
    return mesh.all_gather(tensor[None], axes[0] if len(axes) == 1 else axes)


def shard_item_index(item_index: torch.Tensor, mesh: Mesh, corpus_axis="model") -> torch.Tensor:
    """This rank's rows of ``item_index [V, D]`` padded with zero rows to a
    multiple of the corpus shards (``corpus_axis``: ``"model"``, or
    ``("data", "model")``: the whole mesh, the shard index the rank), a
    copy on the index's device. ``make_sharded_retrieve_fn`` masks the pad
    rows by global id, given the true ``num_items``."""
    n, index = _place(mesh, _mesh_axes(corpus_axis)[0])
    rows = -(-item_index.shape[0] // n)
    shard = item_index[index * rows:(index + 1) * rows]
    if shard.shape[0] < rows:  # the last shards' pad rows
        return F.pad(shard, (0, 0, 0, rows - shard.shape[0]))
    return shard.clone()


def make_sharded_retrieve_fn(model, mesh: Mesh, num_items: int,
                             temperature: Optional[float] = None, chunk_items: int = 65536,
                             approx=False, recall_target: float = 0.99, fused_group: int = 16,
                             corpus_axis="model") -> Retrieve:
    """``retrieve(index_shard, u_ids, k) -> (scores [B, k] f32, item_ids
    [B, k] int32)`` over a corpus sharded by ``shard_item_index``; every rank
    calls it with the whole query batch and gets the whole result back.

    The queries split over the axes the corpus leaves (``"data"`` under
    ``corpus_axis="model"``; none, every rank all of them, where the corpus
    takes the whole mesh). Each rank runs the user tower on its slice and
    selects its shard's top ``k``: fused (B7's bin maxima, then the pad
    rows' bins masked by global id ``>= num_items`` after the bin max, as
    in JAX: a pad row can shadow a valid row of its bin in the last shard),
    or exact (``_topk_scores`` with the pad rows masked before selection;
    ``approx=True`` too, as in ``make_retrieve_fn``). The candidates are
    gathered over the corpus axes in shard order and ranked by one exact
    ``top_k``; the slices are gathered over the query axes."""
    scale = temperature if temperature is not None else (
        model.temperature if model.normalize else None)
    corpus, query = _mesh_axes(corpus_axis)
    device = _device_of(model)

    def retrieve(index_shard: torch.Tensor, u_ids, k: int):
        u_ids = torch.as_tensor(u_ids).to(device)
        n_query, q_index = _place(mesh, query)
        if u_ids.shape[0] % n_query:
            raise ValueError(f"{u_ids.shape[0]} queries do not split over {n_query} query slices")
        step = u_ids.shape[0] // n_query
        base = _place(mesh, corpus)[1] * index_shard.shape[0]
        with torch.inference_mode():
            u_vec = model.user_vectors(u_ids[q_index * step:(q_index + 1) * step])
            if approx == "fused":
                vals, idx = bin_max_scores(u_vec, index_shard, group=fused_group)
                ids = base + idx
                vals = vals.masked_fill(ids >= num_items, float("-inf"))
                if scale is not None:
                    vals = vals / scale
                scores, sel = top_k(vals, k)
                ids = torch.gather(ids, 1, sel)
            else:
                scores, ids = _topk_scores(u_vec, index_shard, k, scale, chunk_items,
                                           n_valid=num_items - base)
                ids = base + ids
            b = scores.shape[0]
            scores, sel = top_k(_gather(mesh, scores, corpus).permute(1, 0, 2).reshape(b, -1), k)
            ids = torch.gather(_gather(mesh, ids, corpus).permute(1, 0, 2).reshape(b, -1), 1, sel)
            return (_gather(mesh, scores, query).reshape(-1, k),
                    _gather(mesh, ids, query).reshape(-1, k))

    return retrieve


def _fused_topk(u_vec: torch.Tensor, item_index: torch.Tensor, k: int, scale=None,
                group: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7's bin maxima, the temperature, the pad-only bins of the last
    super-chunk masked to -inf (their ids are past the corpus, so a k larger
    than the valid bins never returns one above a valid bin), then an exact
    top-k over the bins."""
    vals, idx = bin_max_scores(u_vec, item_index, group=group)
    if scale is not None:
        vals = vals / scale
    vals = vals.masked_fill(idx >= item_index.shape[0], float("-inf"))
    top_vals, sel = top_k(vals, k)
    return top_vals, torch.gather(idx, 1, sel)


def _chunk_scores(u_vec: torch.Tensor, chunk: torch.Tensor, scale) -> torch.Tensor:
    """``[B, C]`` f32 scores of the queries cast to the chunk's dtype. A bf16
    product must not come back in bf16 (nearby scores would tie). On the card
    cuBLAS scores the chunk (bf16 in, f32 out, or f32). On the CPU
    ``ordered_scores`` does, so that equal item rows score equal bits and
    the lower id ranks first among them, as in JAX: the CPU's GEMM gives
    identical rows at different columns different last bits."""
    a = u_vec.to(chunk.dtype)
    if not chunk.is_cuda:
        scores = ordered_scores(a, chunk)
    elif chunk.dtype == torch.bfloat16:
        scores = torch.mm(a, chunk.T, out_dtype=torch.float32)
    else:
        scores = a.float() @ chunk.float().T
    return scores / scale if scale is not None else scores


def _topk_scores(u_vec: torch.Tensor, item_index: torch.Tensor, k: int, scale=None,
                 chunk_items: int = 65536,
                 n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k over the whole index, chunk by chunk with a running
    merge (JAX's ``lax.scan``). The chunks are ``V / n_chunks`` rows where
    that divides, else ``chunk_items`` with the last one's missing rows
    scoring -inf. Rows from ``n_valid`` on are masked to -inf before any
    selection."""
    v = item_index.shape[0]

    def mask_valid(scores, offset):
        if n_valid is None:
            return scores
        cols = offset + torch.arange(scores.shape[1], device=scores.device)
        return scores.masked_fill(cols >= n_valid, float("-inf"))

    def as_int32(result):
        return result[0], result[1].to(torch.int32)

    if v <= chunk_items:
        return as_int32(top_k(mask_valid(_chunk_scores(u_vec, item_index, scale), 0), k))
    n_chunks = -(-v // chunk_items)
    chunk = v // n_chunks if v % n_chunks == 0 else chunk_items
    b = u_vec.shape[0]
    best_s = torch.full((b, k), float("-inf"), device=u_vec.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=u_vec.device)
    for offset in range(0, n_chunks * chunk, chunk):
        scores = _chunk_scores(u_vec, item_index[offset:offset + chunk], scale)
        if scores.shape[1] < chunk:  # the last chunk's missing rows
            scores = F.pad(scores, (0, chunk - scores.shape[1]), value=float("-inf"))
        s, i = top_k(mask_valid(scores, offset), k)
        best_s, sel = top_k(torch.cat([best_s, s], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, i + offset], dim=1), 1, sel)
    return as_int32((best_s, best_i))
