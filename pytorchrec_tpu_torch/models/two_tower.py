"""Two-tower retrieval model with in-batch-negative softmax training (port of
``pytorchrec_tpu/models/two_tower.py``).

A user tower and an item tower each map an id embedding through an MLP
(relu) and a projection to a shared D-dimensional space; the score is their
dot product, cosine-normalized (``x / (|x| + 1e-12)``) and divided by the
temperature when ``normalize``. The parameters keep the flax names, so
converted weights load 1:1 (``utils/convert.py``):

* ``u_embeddings.embedding [V_user, E]`` f32;
* ``i_embeddings.embedding [V_item, E]`` f32, or with ``quantized_table`` the
  item table as int8/int4 packed ``q || scale || acc`` byte rows, the buffer
  ``i_q [V_item, W]`` u8 (``ops/quantized_packed.py``, as DIN's); the user
  table stays f32;
* ``user_mlp``, ``item_mlp`` (``ops/mlp.py``) and the ``user_proj``,
  ``item_proj`` projections.

Batches carry ``uid [B]`` and ``iid [B]`` (point-wise: scores ``[B]`` against
the label) or ``iid [B, N]`` (positive first). Candidate rows score ``[B, N]``
directly, except in training with ``in_batch_negatives``: then each row's
positive is scored against every row's positive, ``[B, B]`` laid out
positive first (the diagonal, then the row without it), for the softmax
loss. There, a batch key ``Q_KEY`` holding each row's raw sampling
probability subtracts ``log q`` from every column (the logQ correction), and
``mask_accidental_hits`` sets a column whose item is the row's own positive
to -1e9 (off the diagonal). Cross-device negatives
(``global_negatives_axis``) come with multi-device training and raise until
then.

Rows injection: ``sharded_table_specs`` (the sparse trainer's protocol) and
``quantized_table_spec`` (the quantized trainer's) name the tables with
their ids and batch keys; the forward reads injected rows in place of its
own gathers.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.models.base import (
    Batch,
    Prediction,
    RecModel,
    label_target,
    one_hot_first_target,
)
from pytorchrec_tpu_torch.ops.embedding import Embedding, normal_init
from pytorchrec_tpu_torch.ops.kernels.quantize import quantize_rows
from pytorchrec_tpu_torch.ops.mlp import MLP, linear
from pytorchrec_tpu_torch.ops.quantized_packed import pack_quantized_table, packed_gather_dequant
from pytorchrec_tpu_torch.utils.device import resolve_device

ACCIDENTAL_HIT_LOGIT = -1e9  # a masked column's logit: exp(-1e9) is 0 in the softmax


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def drop_diagonal(square: torch.Tensor) -> torch.Tensor:
    """``[B, B] -> [B, B-1]``: remove the diagonal, keeping row order, by
    reshapes alone (flatten, drop the last element, view as ``[B-1, B+1]``,
    drop the first column)."""
    b = square.shape[0]
    return square.reshape(b * b)[:-1].reshape(b - 1, b + 1)[:, 1:].reshape(b, b - 1)


class TwoTower(RecModel):
    # batch key of each in-batch item's RAW sampling probability q(i) in (0, 1]
    # (never log-probabilities); the model applies the log
    Q_KEY = "__two_tower_q"
    # batch keys of trainer-gathered rows
    U_ROWS_KEY = "__rows__tt_u"
    I_ROWS_KEY = "__rows__tt_i"

    def __init__(
        self,
        uid_column: CategoricalColumnWithIdentity,
        iid_column: CategoricalColumnWithIdentity,
        label_column: Optional[CategoricalColumnWithIdentity] = None,
        emb_size: int = 64,
        layers: Sequence[int] = (128, 64),
        normalize: bool = True,
        temperature: float = 0.05,
        in_batch_negatives: bool = True,
        mask_accidental_hits: bool = False,
        global_negatives_axis: Optional[str] = None,
        table_row_multiple: int = 1,
        quantized_table: bool = False,
        table_bits: int = 8,
        scale_col_groups: int = 1,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if global_negatives_axis is not None:
            raise NotImplementedError("cross-device negatives come with multi-device training; "
                                      "pass global_negatives_axis=None")
        device = resolve_device(device)
        self.uid_column, self.iid_column = uid_column, iid_column
        self.label_column = label_column
        self.emb_size = emb_size
        self.layers = tuple(layers)
        self.normalize = normalize
        self.temperature = temperature
        self.in_batch_negatives = in_batch_negatives
        self.mask_accidental_hits = mask_accidental_hits
        self.table_row_multiple = table_row_multiple
        self.quantized_table = quantized_table
        self.table_bits = table_bits
        self.scale_col_groups = scale_col_groups
        m = table_row_multiple
        self.u_embeddings = Embedding(_round_up(uid_column.category_num, m), emb_size, device,
                                      generator)
        items = _round_up(iid_column.category_num, m)
        if quantized_table:
            q, scale = quantize_rows(normal_init((items, emb_size), device, generator),
                                     bits=table_bits, col_groups=scale_col_groups)
            acc = torch.zeros((items,), dtype=torch.float32, device=device)
            self.register_buffer("i_q", pack_quantized_table(q, scale, acc, emb_size, table_bits,
                                                             scale_col_groups))
        else:
            self.i_embeddings = Embedding(items, emb_size, device, generator)
        self.user_mlp = MLP(emb_size, self.layers, activation="relu", device=device,
                            generator=generator)
        self.item_mlp = MLP(emb_size, self.layers, activation="relu", device=device,
                            generator=generator)
        self.user_proj = linear(self.layers[-1], self.layers[-1], device=device, generator=generator)
        self.item_proj = linear(self.layers[-1], self.layers[-1], device=device, generator=generator)

    @property
    def has_quantized_table(self) -> bool:
        return self.quantized_table

    # --- towers (also the serving and index-build entries) ---

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        """L2 normalization with the JAX package's ``+ 1e-12`` on the norm
        (not ``F.normalize``'s ``max(|x|, eps)``)."""
        if not self.normalize:
            return x
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)

    def user_vectors_from(self, u_emb: torch.Tensor, train: bool = False,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._norm(self.user_proj(self.user_mlp(u_emb, train=train, generator=generator)))

    def item_vectors_from(self, i_emb: torch.Tensor, train: bool = False,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._norm(self.item_proj(self.item_mlp(i_emb, train=train, generator=generator)))

    def user_vectors(self, u_ids: torch.Tensor) -> torch.Tensor:
        """ids ``[...]`` -> tower output ``[..., D]``: the serving entry."""
        return self.user_vectors_from(self.u_embeddings(u_ids))

    def item_vectors(self, i_ids: torch.Tensor) -> torch.Tensor:
        """ids ``[...]`` -> tower output ``[..., D]``: the index-build entry."""
        return self.item_vectors_from(self._item_emb(i_ids))

    def _item_emb(self, ids: torch.Tensor) -> torch.Tensor:
        if self.quantized_table:
            return packed_gather_dequant(self.i_q, ids, self.emb_size, self.table_bits,
                                         self.scale_col_groups)
        return self.i_embeddings(ids)

    def _scale(self, logits: torch.Tensor) -> torch.Tensor:
        return logits / self.temperature if self.normalize else logits

    # --- training / eval forward ---

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        u_ids = self.uid_column.get_feature_data(batch)  # [B]
        i_ids = self.iid_column.get_feature_data(batch)  # [B] or [B, N]
        u_rows = batch.get(self.U_ROWS_KEY)
        i_rows = batch.get(self.I_ROWS_KEY)
        u_emb = (u_rows.reshape(*u_ids.shape, self.emb_size) if u_rows is not None
                 else self.u_embeddings(u_ids))
        i_emb = (i_rows.reshape(*i_ids.shape, self.emb_size) if i_rows is not None
                 else self._item_emb(i_ids))
        u_vec = self.user_vectors_from(u_emb, train, generator)  # [B, D]
        i_vec = self.item_vectors_from(i_emb, train, generator)  # [B(, N), D]

        if i_ids.dim() == 1:  # point-wise rows
            prediction = self._scale((u_vec * i_vec).sum(dim=-1))
            return prediction, label_target(self.label_column, batch)

        if train and self.in_batch_negatives:
            # each row's positive against every in-batch positive: [B, B]
            pos_ids = i_ids[:, 0]
            logits = self._scale(u_vec @ i_vec[:, 0, :].T)
            q = batch.get(self.Q_KEY)
            if q is not None:
                # Yi et al. 2019 eq. 6, every column (the positive's too); q is
                # cast to f32 first, so a float64 column does not promote
                q = torch.as_tensor(q).to(device=logits.device, dtype=torch.float32)
                logits = logits - torch.log(q)[None, :]
            if self.mask_accidental_hits:
                b = logits.shape[0]
                dup = pos_ids[None, :] == pos_ids[:, None]
                off_diag = ~torch.eye(b, dtype=torch.bool, device=logits.device)
                logits = logits.masked_fill(dup & off_diag, ACCIDENTAL_HIT_LOGIT)
            prediction = torch.cat([torch.diagonal(logits)[:, None], drop_diagonal(logits)],
                                   dim=-1)  # [B, B] positive first
            return prediction, one_hot_first_target(prediction)

        # candidate scoring (eval / sampled-negative training)
        prediction = self._scale(torch.einsum("bd,bnd->bn", u_vec, i_vec))
        return prediction, one_hot_first_target(prediction)

    # --- sparse and quantized trainer protocols ---

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Sparse-trainer protocol: table path -> the ids that gather from it."""
        return {"u_embeddings/embedding": self.uid_column.get_feature_data(batch),
                "i_embeddings/embedding": self.iid_column.get_feature_data(batch)}

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        """Rows-injection protocol: each table's flax path, ids and batch key.
        With ``quantized_table`` the item spec names the packed byte-row leaf
        ``i_q`` and carries its format under ``"quantized"``."""
        i_spec = {"ids": self.iid_column.get_feature_data(batch), "rows_key": self.I_ROWS_KEY}
        if self.quantized_table:
            i_spec["path"] = "i_q"
            i_spec["quantized"] = {"emb_size": self.emb_size, "bits": self.table_bits,
                                   "col_groups": self.scale_col_groups}
        else:
            i_spec["path"] = "i_embeddings/embedding"
        return {"u": {"path": "u_embeddings/embedding",
                      "ids": self.uid_column.get_feature_data(batch),
                      "rows_key": self.U_ROWS_KEY},
                "i": i_spec}

    def quantized_table_spec(self, batch: Batch) -> Dict[str, dict]:
        """Quantized-trainer protocol: the packed item table updates over its
        touched byte rows; the user table and the towers train under the
        dense optimizer."""
        if not self.quantized_table:
            raise ValueError("QuantizedEmbeddingTrainer needs TwoTower(quantized_table=True)")
        return {"i": {"q": "i_q", "scale": None, "ids": self.iid_column.get_feature_data(batch),
                      "rows_key": self.I_ROWS_KEY, "bits": self.table_bits,
                      "col_groups": self.scale_col_groups, "packed": True,
                      "emb_size": self.emb_size}}
