"""CTR family (port of ``pytorchrec_tpu/models/ctr.py``): DCN-v2 for now.

The embedding layouts of ``_CTRBase`` come over as they are, with the flax
parameter names, so converted weights load 1:1 (``utils/convert.py``):

* per-field tables ``emb_<field>.embedding [vocab, E]``;
* one unified offset-indexed f32 table ``unified_emb.embedding [sum(vocab), E]``;
* one unified int8/int4 packed byte-row table ``unified_q [sum(vocab), W]``
  u8 (``ops/quantized_packed.py``), with ``scale_col_groups`` scales a row.

Fields arriving ``[B]`` are broadcast against candidate fields ``[B, N]``.

Rows injection: ``sharded_table_specs(batch)`` (the sparse trainer's
protocol) names the unified f32 table, and ``quantized_table_spec(batch)``
(the quantized trainer's) the unified packed quantized table, each with its
ids ``[..., F_sparse]`` and the batch key ``ROWS_KEY``; when the batch
carries rows under that key, the model reads them in place of its own
gather, so the trainer can gather packed rows once and take the loss's
gradient with respect to the rows themselves.

The linear term (``bias``, ``dense_factors``, ``dense_linear``, the
``lin_*`` tables) and the classic unpacked ``q``/``scale`` leaves come with
the LR/FM slice: DCN-v2 never reads them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.models.base import (
    Batch,
    Prediction,
    RecModel,
    label_target,
    one_hot_first_target,
)
from pytorchrec_tpu_torch.ops.embedding import Embedding, normal_init
from pytorchrec_tpu_torch.ops.interactions import CrossNetworkV2
from pytorchrec_tpu_torch.ops.kernels.quantize import quantize_rows
from pytorchrec_tpu_torch.ops.mlp import MLP, linear
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
    # batch key of trainer-gathered rows of the unified table
    ROWS_KEY = "__rows__unified"
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
        if not self.unified_embedding:
            self.field_embeddings = []
            for c in self.sparse_columns:
                emb = Embedding(c.category_num, self.emb_size, device, generator)
                self.add_module(f"emb_{c.feature_name}", emb)
                self.field_embeddings.append(emb)
            return
        self._offsets, total = self._field_offsets()
        if not self.quantized_embedding:
            self.unified_emb = Embedding(total, self.emb_size, device, generator)
            return
        if not self.table_packed:
            raise NotImplementedError(
                "the unpacked q/scale quantized leaves are not ported yet; use table_packed=True")
        rows = normal_init((total, self.emb_size), device, generator)
        q, scale = quantize_rows(rows, bits=self.table_bits, col_groups=self.scale_col_groups)
        acc = torch.zeros((total,), dtype=torch.float32, device=device)
        self.register_buffer("unified_q", pack_quantized_table(
            q, scale, acc, self.emb_size, self.table_bits, self.scale_col_groups))

    def _unified_ids(self, sparse) -> torch.Tensor:
        """Stack per-field ids with their offsets -> [..., F_sparse]."""
        return torch.stack([ids + off for ids, off in zip(sparse, self._offsets)], dim=-1)

    def _unified_vectors(self, sparse, batch: Optional[Batch] = None) -> torch.Tensor:
        """[..., F_sparse, E] from the unified table (f32 or packed quantized),
        or the rows the trainer injected under ``ROWS_KEY``."""
        ids = self._unified_ids(sparse)
        rows = batch.get(self.ROWS_KEY) if batch is not None else None
        if rows is not None:
            return rows.reshape(*ids.shape, self.emb_size)
        if self.quantized_embedding:
            return packed_gather_dequant(self.unified_q, ids, self.emb_size,
                                         self.table_bits, self.scale_col_groups)
        return self.unified_emb(ids)

    def _embedded_concat(self, sparse, batch: Optional[Batch] = None) -> torch.Tensor:
        """All sparse-field embeddings concatenated: [..., F_sparse * E]."""
        if self.unified_embedding:
            vectors = self._unified_vectors(sparse, batch)
            return vectors.reshape(*vectors.shape[:-2], -1)
        return torch.cat([emb(ids) for emb, ids in zip(self.field_embeddings, sparse)], dim=-1)

    def _finish(self, prediction: torch.Tensor, candidate_mode: bool, batch: Batch) -> Prediction:
        if candidate_mode:
            return prediction, one_hot_first_target(prediction)
        return prediction, label_target(self.label_column, batch)

    def _check_trainable_table(self, quantized: bool) -> None:
        """The sparse trainer takes the unified f32 table, the quantized
        trainer the unified quantized one."""
        if not self.unified_embedding:
            raise NotImplementedError("sparse training of per-field tables is not ported yet; "
                                      "use unified_embedding=True")
        if self.quantized_embedding and not quantized:
            raise ValueError("a quantized table trains under QuantizedEmbeddingTrainer")
        if quantized and not self.quantized_embedding:
            raise ValueError("QuantizedEmbeddingTrainer needs quantized_embedding=True")

    def quantized_table_spec(self, batch: Batch) -> Dict[str, dict]:
        """Quantized-trainer protocol: the unified quantized table's flax
        path, its ids ``[..., F_sparse]`` for ``batch``, the batch key of its
        rows and its format."""
        self._check_trainable_table(quantized=True)
        sparse, _, _ = _gather_fields(batch, self.sparse_columns, self.dense_columns)
        return {"unified": {
            "q": "unified_q", "scale": None if self.table_packed else "unified_scale",
            "ids": self._unified_ids(sparse), "rows_key": self.ROWS_KEY,
            "bits": self.table_bits, "col_groups": self.scale_col_groups,
            "packed": self.table_packed, "emb_size": self.emb_size}}

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        """Rows-injection protocol: the unified f32 table's flax path, its ids
        ``[..., F_sparse]`` for ``batch`` and the batch key of its rows."""
        self._check_trainable_table(quantized=False)
        sparse, _, _ = _gather_fields(batch, self.sparse_columns, self.dense_columns)
        return {"unified": {"path": "unified_emb/embedding", "ids": self._unified_ids(sparse),
                            "rows_key": self.ROWS_KEY}}

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Sparse-trainer protocol: table path -> the flat ids that gather from
        it (field after field, as in the JAX package)."""
        self._check_trainable_table(quantized=False)
        fields = [(c.get_feature_data(batch), off)
                  for c, off in zip(self.sparse_columns, self._offsets)]
        parts = [(ids + off).reshape(-1) for ids, off in fields if ids is not None]
        ids = torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.int64)
        return {"unified_emb/embedding": ids}


class DCNv2(_CTRBase):
    """DCN-v2: cross network and deep network in parallel over
    ``x0 = [sparse embeddings || dense values]``; the linear head reads
    ``[cross_out || deep_out]`` and returns the logit."""

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
