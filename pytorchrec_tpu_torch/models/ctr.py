"""CTR family (port of ``pytorchrec_tpu/models/ctr.py``): LR, FM, DeepFM,
DCN-v2 and DLRM.

The embedding layouts of ``_CTRBase`` come over as they are, with the flax
parameter names, so converted weights load 1:1 (``utils/convert.py``):

* per-field tables ``emb_<field>.embedding [vocab, E]`` and, for the linear
  term, ``lin_<field>.embedding [vocab, 1]``;
* one unified offset-indexed f32 table ``unified_emb.embedding [sum(vocab), E]``
  and the linear table ``unified_lin.embedding [sum(vocab), 1]``;
* one unified int8/int4 packed byte-row table ``unified_q [sum(vocab), W]``
  u8 (``ops/quantized_packed.py``), with ``scale_col_groups`` scales a row
  (``table_packed=True``), or the classic pair of buffers ``unified_q``
  int8 ``[sum(vocab), E]`` (int4: ``[sum(vocab), E/2]`` nibble-packed) and
  ``unified_scale`` f32 ``[sum(vocab)]`` (``[sum(vocab), G]`` with G column
  groups) (``table_packed=False``, the JAX package's default); the linear
  table stays f32 beside either;
* the linear term's dense parameters ``dense_linear [F_dense]`` and the
  global ``bias``, and the dense fields' factor vectors ``dense_factors
  [F_dense, E]``.

A model creates only what it reads (``_uses_field_embeddings``,
``_uses_linear``). Flax creates a submodule's parameters only when it is
called, but ``self.param`` leaves at once, so a JAX DCN-v2 tree holds
``bias``, ``dense_factors`` and ``dense_linear`` unread, and a JAX LR tree
``dense_factors``; the converter drops those.

Fields arriving ``[B]`` are broadcast against candidate fields ``[B, N]``.

Rows injection: ``sharded_table_specs(batch)`` (the sparse trainer's
protocol, unified tables only, as in the JAX package) names the unified f32
tables a model reads, ``injection_specs(batch)`` every f32 table it reads in
either layout (per-field: ``emb_<field>`` and ``lin_<field>``, each under
its own batch key ``__rows__emb_<field>`` or ``__rows__lin_<field>``), and
``quantized_table_spec(batch)`` (the quantized trainer's) the unified
quantized table, packed or classic; each comes with its ids and a batch key
(``ROWS_KEY``, ``LIN_ROWS_KEY``); when the batch carries rows under that
key, the model reads them in place of its own gather, so the trainer can
gather the rows once and take the loss's gradient with respect to the rows
themselves.

The classic table's init keeps the JAX package's quirk: ``q`` and ``scale``
come from two independent N(0, 0.01) draws, each rounded to nearest, so a
row's initial values are not one draw's (the first quantized update
re-establishes them).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.models.base import (
    Batch,
    Prediction,
    RecModel,
    label_target,
    one_hot_first_target,
)
from pytorchrec_tpu_torch.ops.embedding import INIT_STD, Embedding, normal_init
from pytorchrec_tpu_torch.ops.interactions import CrossNetworkV2, dot_interaction, fm_interaction
from pytorchrec_tpu_torch.ops.kernels.quantize import dequantize_rows, quantize_rows
from pytorchrec_tpu_torch.ops.mlp import MLP, Linear, linear
from pytorchrec_tpu_torch.ops.quantized_packed import pack_quantized_table, packed_gather_dequant
from pytorchrec_tpu_torch.utils.device import resolve_device


def _gather_fields(batch: Batch, sparse_columns, dense_columns) -> Tuple[list, list, bool]:
    """Pull field arrays; broadcast [B] fields to [B, N] when any field is 2-D.

    Returns (sparse_ids, dense_values, candidate_mode).
    """
    sparse = [c.get_feature_data(batch) for c in sparse_columns]
    dense = [c.get_feature_data(batch) for c in dense_columns]
    present = [a for a in sparse + dense if a is not None]
    candidate_mode = any(a.dim() == 2 for a in present)
    if candidate_mode:
        shape2 = next(a.shape for a in present if a.dim() == 2)
        sparse = [a[:, None].expand(shape2) if a.dim() == 1 else a for a in sparse]
        dense = [a[:, None].expand(shape2) if a.dim() == 1 else a for a in dense]
    return sparse, dense, candidate_mode


class _CTRBase(RecModel):
    # batch keys of trainer-gathered rows of the unified tables
    ROWS_KEY = "__rows__unified"
    LIN_ROWS_KEY = "__rows__unified_lin"
    # what the model reads, and so creates: the second-order field tables
    # (and, with the linear term, the dense fields' factor vectors), and the
    # linear term (linear tables, ``dense_linear``, ``bias``)
    _uses_field_embeddings = True
    _uses_linear = True
    # the CTR family trains its rowwise-Adagrad tables at the shared dense
    # lr (``training/sparse_trainer.py::resolve_table_lr``)
    table_lr_shared_ok = True

    def __init__(
        self,
        sparse_columns: Sequence[CategoricalColumnWithIdentity] = (),
        dense_columns: Sequence[NumericColumn] = (),
        label_column: Optional[CategoricalColumnWithIdentity] = None,
        emb_size: int = 16,
        unified_embedding: bool = False,
        quantized_embedding: bool = False,
        table_bits: int = 8,
        scale_col_groups: int = 1,
        table_packed: bool = False,
        table_row_multiple: int = 1,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.sparse_columns = tuple(sparse_columns)
        self.dense_columns = tuple(dense_columns)
        self.label_column = label_column
        self.emb_size = emb_size
        self.unified_embedding = unified_embedding
        self.quantized_embedding = quantized_embedding
        self.table_bits = table_bits
        self.scale_col_groups = scale_col_groups
        self.table_packed = table_packed
        self.table_row_multiple = table_row_multiple
        self._build_embeddings(resolve_device(device), generator)

    def _field_offsets(self):
        sizes = [c.category_num for c in self.sparse_columns]
        offsets = [0]
        for size in sizes[:-1]:
            offsets.append(offsets[-1] + size)
        m = self.table_row_multiple
        return offsets, -(-sum(sizes) // m) * m

    def _build_embeddings(self, device: torch.device, generator) -> None:
        if self.quantized_embedding and not self.unified_embedding:
            raise ValueError("quantized_embedding requires unified_embedding")
        if self.quantized_embedding and not self._uses_field_embeddings:
            raise ValueError(f"{type(self).__name__} has no field table to quantize")
        fields = self._uses_field_embeddings
        if not self.unified_embedding:
            self.field_embeddings, self.first_order = [], []
            for c in self.sparse_columns:
                if fields:
                    emb = Embedding(c.category_num, self.emb_size, device, generator)
                    self.add_module(f"emb_{c.feature_name}", emb)
                    self.field_embeddings.append(emb)
                if self._uses_linear:
                    lin = Embedding(c.category_num, 1, device, generator)
                    self.add_module(f"lin_{c.feature_name}", lin)
                    self.first_order.append(lin)
        else:
            self._offsets, total = self._field_offsets()
            if fields and not self.quantized_embedding:
                self.unified_emb = Embedding(total, self.emb_size, device, generator)
            elif fields:
                formats = dict(bits=self.table_bits, col_groups=self.scale_col_groups)
                q, scale = quantize_rows(normal_init((total, self.emb_size), device, generator),
                                         **formats)
                if self.table_packed:
                    acc = torch.zeros((total,), dtype=torch.float32, device=device)
                    self.register_buffer("unified_q", pack_quantized_table(
                        q, scale, acc, self.emb_size, self.table_bits, self.scale_col_groups))
                else:
                    # the scale from a second, independent draw (the JAX init)
                    _, scale = quantize_rows(
                        normal_init((total, self.emb_size), device, generator), **formats)
                    self.register_buffer("unified_q", q)
                    self.register_buffer("unified_scale", scale)
            if self._uses_linear:
                self.unified_lin = Embedding(total, 1, device, generator)
        if self._uses_linear:
            n_dense = len(self.dense_columns)
            if n_dense and fields:  # read by _field_vectors
                self.dense_factors = nn.Parameter(
                    normal_init((n_dense, self.emb_size), device, generator))
            if n_dense:
                self.dense_linear = nn.Parameter(normal_init((n_dense,), device, generator))
            self.bias = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))

    def _unified_ids(self, sparse) -> torch.Tensor:
        """Stack per-field ids with their offsets -> [..., F_sparse]."""
        return torch.stack([ids + off for ids, off in zip(sparse, self._offsets)], dim=-1)

    def _unified_vectors(self, sparse, batch: Optional[Batch] = None) -> torch.Tensor:
        """[..., F_sparse, E] from the unified table (f32, packed quantized or
        classic quantized), or the rows the trainer injected under
        ``ROWS_KEY``."""
        ids = self._unified_ids(sparse)
        rows = batch.get(self.ROWS_KEY) if batch is not None else None
        if rows is not None:
            return rows.reshape(*ids.shape, self.emb_size)
        if self.quantized_embedding and self.table_packed:
            return packed_gather_dequant(self.unified_q, ids, self.emb_size,
                                         self.table_bits, self.scale_col_groups)
        if self.quantized_embedding:
            flat = ids.reshape(-1)
            rows = dequantize_rows(self.unified_q.index_select(0, flat),
                                   self.unified_scale.index_select(0, flat),
                                   bits=self.table_bits, col_groups=self.scale_col_groups)
            return rows.reshape(*ids.shape, self.emb_size)
        return self.unified_emb(ids)

    @staticmethod
    def _rows_key(kind: str, column) -> str:
        """The batch key of a per-field table's injected rows (``kind``
        ``"emb"`` or ``"lin"``)."""
        return f"__rows__{kind}_{column.feature_name}"

    def _field_rows(self, kind: str, sparse, batch: Optional[Batch] = None) -> list:
        """Each per-field table's rows at its field's ids, ``[..., E]``
        (``[..., 1]`` for the linear tables), or the rows the trainer
        injected under its key."""
        tables = self.field_embeddings if kind == "emb" else self.first_order
        out = []
        for column, table, ids in zip(self.sparse_columns, tables, sparse):
            rows = batch.get(self._rows_key(kind, column)) if batch is not None else None
            out.append(table(ids) if rows is None else rows.reshape(*ids.shape, table.features))
        return out

    def _sparse_vectors(self, sparse, batch: Optional[Batch] = None) -> torch.Tensor:
        """The sparse fields' vectors ``[..., F_sparse, E]``, in either
        layout."""
        if self.unified_embedding:
            return self._unified_vectors(sparse, batch)
        return torch.stack(self._field_rows("emb", sparse, batch), dim=-2)

    def _embedded_concat(self, sparse, batch: Optional[Batch] = None) -> torch.Tensor:
        """All sparse-field embeddings concatenated: [..., F_sparse * E]."""
        vectors = self._sparse_vectors(sparse, batch)
        return vectors.reshape(*vectors.shape[:-2], -1)

    def _field_vectors(self, sparse, dense, batch: Optional[Batch] = None) -> torch.Tensor:
        """Every field's vector -> ``[..., F, E]``: the sparse fields' rows,
        then each dense value times its factor vector (the FM input)."""
        vectors = [self._sparse_vectors(sparse, batch)]
        if dense:
            vectors.append(torch.stack(dense, dim=-1)[..., None] * self.dense_factors)
        return torch.cat(vectors, dim=-2)

    def _linear_term(self, sparse, dense, batch: Optional[Batch] = None) -> torch.Tensor:
        """``bias + sum of the sparse fields' linear rows + sum_i dense_i *
        dense_linear_i``; the rows may come injected (``LIN_ROWS_KEY``, or
        each field's key)."""
        total = self.bias
        if self.unified_embedding:
            ids = self._unified_ids(sparse)
            lin_rows = batch.get(self.LIN_ROWS_KEY) if batch is not None else None
            if lin_rows is None:
                lin_rows = self.unified_lin(ids)
            total = total + lin_rows.reshape(ids.shape).sum(dim=-1)
        else:
            for rows in self._field_rows("lin", sparse, batch):
                total = total + rows[..., 0]
        for i, values in enumerate(dense):
            total = total + values * self.dense_linear[i]
        return total

    def _finish(self, prediction: torch.Tensor, candidate_mode: bool, batch: Batch) -> Prediction:
        if candidate_mode:
            return prediction, one_hot_first_target(prediction)
        return prediction, label_target(self.label_column, batch)

    @property
    def has_quantized_table(self) -> bool:
        return self.quantized_embedding

    def _check_trainable_table(self, quantized: bool) -> None:
        """The sparse trainer takes the f32 tables, the quantized trainer the
        unified quantized one."""
        if self.quantized_embedding and not quantized:
            raise ValueError("a quantized table trains under QuantizedEmbeddingTrainer")
        if quantized and not self.quantized_embedding:
            raise ValueError("QuantizedEmbeddingTrainer needs quantized_embedding=True")

    def quantized_table_spec(self, batch: Batch) -> Dict[str, dict]:
        """Quantized-trainer protocol: the unified quantized table's flax
        paths (``q``, and ``scale`` for the classic table), its ids
        ``[..., F_sparse]`` for ``batch``, the batch key of its rows and its
        format."""
        self._check_trainable_table(quantized=True)
        sparse, _, _ = _gather_fields(batch, self.sparse_columns, self.dense_columns)
        return {"unified": {
            "q": "unified_q", "scale": None if self.table_packed else "unified_scale",
            "ids": self._unified_ids(sparse), "rows_key": self.ROWS_KEY,
            "bits": self.table_bits, "col_groups": self.scale_col_groups,
            "packed": self.table_packed, "emb_size": self.emb_size}}

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        """Rows-injection protocol: each unified f32 table the model reads
        (the linear table, the field table), with its flax path, its ids
        ``[..., F_sparse]`` for ``batch`` and the batch key of its rows.
        Unified tables only, as the JAX package asserts: per-field tables
        raise ValueError (``injection_specs`` names them). With
        ``quantized_embedding=True`` (and ``table_packed=True``, else
        ValueError) the field table's spec names the packed byte-row buffer
        ``unified_q`` and carries a ``"quantized"`` block (bits, column
        groups, E), as the JAX model's does: the sharded trainer ships its
        int8 rows and scales on the exchange."""
        if not self.unified_embedding:
            raise ValueError("sharded_table_specs needs unified_embedding=True")
        if self.quantized_embedding and not self.table_packed:
            raise ValueError("sharded quantized tables need table_packed=True (q||scale||acc "
                             "byte rows: the owner's update reads them in the row)")
        sparse, _, _ = _gather_fields(batch, self.sparse_columns, self.dense_columns)
        ids = self._unified_ids(sparse)
        specs = {}
        if self._uses_linear:
            specs["unified_lin"] = {"path": "unified_lin/embedding", "ids": ids,
                                    "rows_key": self.LIN_ROWS_KEY}
        if self._uses_field_embeddings and self.quantized_embedding:
            specs["unified"] = {"path": "unified_q", "ids": ids, "rows_key": self.ROWS_KEY,
                                "quantized": {"bits": self.table_bits,
                                              "col_groups": self.scale_col_groups,
                                              "emb_size": self.emb_size}}
        elif self._uses_field_embeddings:
            specs["unified"] = {"path": "unified_emb/embedding", "ids": ids,
                                "rows_key": self.ROWS_KEY}
        return specs

    def injection_specs(self, batch: Batch) -> Dict[str, dict]:
        """Every f32 table the model reads, in the form of
        ``sharded_table_specs``: the unified tables' specs, or each per-field
        table (``emb_<field>/embedding``, ``lin_<field>/embedding``) with its
        field's ids (broadcast against candidate fields, as the model gathers
        them) and its own batch key."""
        if self.unified_embedding:
            return self.sharded_table_specs(batch)
        sparse, _, _ = _gather_fields(batch, self.sparse_columns, self.dense_columns)
        specs = {}
        for column, ids in zip(self.sparse_columns, sparse):
            kinds = ("lin",) * self._uses_linear + ("emb",) * self._uses_field_embeddings
            for kind in kinds:
                name = f"{kind}_{column.feature_name}"
                specs[name] = {"path": f"{name}/embedding", "ids": ids,
                               "rows_key": self._rows_key(kind, column)}
        return specs

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Sparse-trainer protocol: table path -> the flat ids that gather from
        it (unified: field after field; per-field: each field's own ids, as
        in the JAX package)."""
        self._check_trainable_table(quantized=False)
        if not self.unified_embedding:
            ids_map = {}
            for column in self.sparse_columns:
                ids = column.get_feature_data(batch)
                if ids is None:
                    continue
                if self._uses_linear:
                    ids_map[f"lin_{column.feature_name}/embedding"] = ids
                if self._uses_field_embeddings:
                    ids_map[f"emb_{column.feature_name}/embedding"] = ids
            return ids_map
        fields = [(c.get_feature_data(batch), off)
                  for c, off in zip(self.sparse_columns, self._offsets)]
        parts = [(ids + off).reshape(-1) for ids, off in fields if ids is not None]
        ids = torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.int64)
        paths = []
        if self._uses_linear:
            paths.append("unified_lin/embedding")
        if self._uses_field_embeddings:
            paths.append("unified_emb/embedding")
        return {path: ids for path in paths}


class DCNv2(_CTRBase):
    """DCN-v2: cross network and deep network in parallel over
    ``x0 = [sparse embeddings || dense values]``; the linear head reads
    ``[cross_out || deep_out]`` and returns the logit. It reads no linear
    term, so it creates none (the JAX model declares one and never reads
    it)."""

    _uses_linear = False

    def __init__(self, *args, num_cross_layers: int = 3,
                 layers: Sequence[int] = (256, 128), dropout: float = 0.0,
                 device=None, generator: Optional[torch.Generator] = None, **kwargs):
        device = resolve_device(device)
        super().__init__(*args, device=device, generator=generator, **kwargs)
        dim = len(self.sparse_columns) * self.emb_size + len(self.dense_columns)
        self.cross = CrossNetworkV2(num_cross_layers, dim, device, generator)
        self.deep = MLP(dim, tuple(layers), activation="relu", dropout=dropout,
                        device=device, generator=generator)
        self.head = linear(dim + self.deep.out_features, 1, device=device,
                           generator=generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        sparse, dense, candidate_mode = _gather_fields(batch, self.sparse_columns,
                                                       self.dense_columns)
        x0_parts = [self._embedded_concat(sparse, batch)]
        if dense:
            x0_parts.append(torch.stack(dense, dim=-1))
        x0 = torch.cat(x0_parts, dim=-1)
        cross_out = self.cross(x0)
        deep_out = self.deep(x0, train=train, generator=generator)
        prediction = self.head(torch.cat([cross_out, deep_out], dim=-1))[..., 0]
        return self._finish(prediction, candidate_mode, batch)


class LR(_CTRBase):
    """Logistic regression: the linear term alone (a logit)."""

    _uses_field_embeddings = False

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        sparse, dense, candidate_mode = _gather_fields(batch, self.sparse_columns,
                                                       self.dense_columns)
        return self._finish(self._linear_term(sparse, dense, batch), candidate_mode, batch)


class FM(_CTRBase):
    """Factorization machine: the linear term plus the pairwise second-order
    term of all field vectors."""

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        sparse, dense, candidate_mode = _gather_fields(batch, self.sparse_columns,
                                                       self.dense_columns)
        vectors = self._field_vectors(sparse, dense, batch)
        prediction = self._linear_term(sparse, dense, batch) + fm_interaction(vectors)
        return self._finish(prediction, candidate_mode, batch)


class DeepFM(_CTRBase):
    """FM plus a deep MLP tower over the concatenated field vectors (the FM
    and the deep part share the embeddings, as in the original paper); the
    tower's head ``deep_head`` has no bias."""

    def __init__(self, *args, layers: Sequence[int] = (256, 128), dropout: float = 0.0,
                 device=None, generator: Optional[torch.Generator] = None, **kwargs):
        device = resolve_device(device)
        super().__init__(*args, device=device, generator=generator, **kwargs)
        dim = (len(self.sparse_columns) + len(self.dense_columns)) * self.emb_size
        self.deep = MLP(dim, tuple(layers), activation="relu", dropout=dropout,
                        device=device, generator=generator)
        self.deep_head = linear(self.deep.out_features, 1, use_bias=False, device=device,
                                generator=generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        sparse, dense, candidate_mode = _gather_fields(batch, self.sparse_columns,
                                                       self.dense_columns)
        vectors = self._field_vectors(sparse, dense, batch)  # [..., F, E]
        fm_term = self._linear_term(sparse, dense, batch) + fm_interaction(vectors)
        flat = vectors.reshape(*vectors.shape[:-2], -1)  # [..., F * E]
        deep_term = self.deep_head(self.deep(flat, train=train, generator=generator))[..., 0]
        return self._finish(fm_term + deep_term, candidate_mode, batch)


class _ZeroBiasLinear(Linear):
    """``Linear`` drawn as flax's ``nn.Dense`` with its default bias init:
    normal(0, 0.01) weight, zero bias, at construction and at each
    ``Trainer.init_state`` (``init_parameters``)."""

    def __init__(self, in_features: int, out_features: int, device,
                 generator: Optional[torch.Generator]):
        super().__init__(in_features, out_features, device=device)
        with torch.no_grad():
            self.init_parameters(generator)

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.normal_(0.0, INIT_STD, generator=generator)
        self.bias.zero_()


class DLRM(_CTRBase):
    """DLRM (Naumov et al., arXiv 1906.00091): a bottom MLP over the dense
    values, projected to ``emb_size`` (``bottom_proj``), joins the sparse
    fields' vectors as one more field vector; the pairwise dot interaction
    of all field vectors (``ops/interactions.py::dot_interaction``) and the
    dense vector feed the top MLP and its head (``top_head``). No linear
    term, so no linear tables. ``bottom_proj`` and ``top_head`` start with
    zero biases, as the flax model's, and run through ``ops.mlp.Linear``, so
    ``compile(matmul_precision=...)`` covers them; the Gram matrix stays f32.
    Every table layout of the family: unified f32, per-field, int8 packed
    and classic."""

    _uses_linear = False

    def __init__(self, *args, bottom_layers: Sequence[int] = (64,),
                 top_layers: Sequence[int] = (256, 128), dropout: float = 0.0,
                 self_interaction: bool = False, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        device = resolve_device(device)
        super().__init__(*args, device=device, generator=generator, **kwargs)
        self.self_interaction = self_interaction
        n_dense = len(self.dense_columns)
        fields = len(self.sparse_columns) + (1 if n_dense else 0)
        top_in = fields * (fields + 1) // 2 if self_interaction else fields * (fields - 1) // 2
        if n_dense:
            self.bottom = MLP(n_dense, tuple(bottom_layers), activation="relu", dropout=dropout,
                              device=device, generator=generator)
            self.bottom_proj = _ZeroBiasLinear(self.bottom.out_features, self.emb_size, device,
                                               generator)
            top_in += self.emb_size
        self.top = MLP(top_in, tuple(top_layers), activation="relu", dropout=dropout,
                       device=device, generator=generator)
        self.top_head = _ZeroBiasLinear(self.top.out_features, 1, device, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        sparse, dense, candidate_mode = _gather_fields(batch, self.sparse_columns,
                                                       self.dense_columns)
        vectors = self._sparse_vectors(sparse, batch)  # [..., F_sparse, E]
        top_in = []
        if dense:
            dense_x = torch.stack(dense, dim=-1)  # [..., F_dense]
            dense_vec = self.bottom_proj(self.bottom(dense_x, train=train, generator=generator))
            vectors = torch.cat([vectors, dense_vec[..., None, :]], dim=-2)
            top_in.append(dense_vec)
        top_in.append(dot_interaction(vectors, self.self_interaction))
        top = self.top(torch.cat(top_in, dim=-1), train=train, generator=generator)
        return self._finish(self.top_head(top)[..., 0], candidate_mode, batch)
