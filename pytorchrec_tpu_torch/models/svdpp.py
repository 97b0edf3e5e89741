"""SVD++ (port of ``pytorchrec_tpu/models/svdpp.py``): matrix factorization
with user, item and global biases and an implicit-feedback vector.

The batch carries the user id ``[B]``, the item ids ``[B]`` or ``[B, N]``
(positive first) and the implicit history ``[B, H]`` (0 = PAD). The
implicit vector is the sum of the history's rows where the id is above 0
(column 0 is not forced valid, unlike the sequence models' mask) over the
square root of their count, so a row with no implicit id is NaN, as in
the JAX package. Parameters keep the flax names: ``u_embeddings``,
``i_embeddings`` and ``implicit_i_embeddings`` (E columns), ``u_bias`` and
``i_bias`` (E = 1; a packed leaf of 64 columns under the sparse trainer,
as DeepFM's linear table) and the scalar ``global_bias`` (init 0). With
``quantized_table`` the item and implicit tables are the packed byte-row
buffers ``i_q`` and ``implicit_i_q``, each salted apart by the quantized
trainer; the user table and the biases stay f32 under the dense
optimizer.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.models.base import (
    Batch,
    PackedTablesModel,
    Prediction,
    label_target,
    one_hot_first_target,
    sharded_spec,
)
from pytorchrec_tpu_torch.ops.embedding import Embedding
from pytorchrec_tpu_torch.utils.device import resolve_device


class SVDPP(PackedTablesModel):
    U_ROWS_KEY = "__rows__svdpp_u"
    I_ROWS_KEY = "__rows__svdpp_i"
    IMP_ROWS_KEY = "__rows__svdpp_imp"
    UB_ROWS_KEY = "__rows__svdpp_ub"
    IB_ROWS_KEY = "__rows__svdpp_ib"

    def __init__(
        self,
        uid_column: CategoricalColumnWithIdentity,
        iid_column: CategoricalColumnWithIdentity,
        iids_column: CategoricalColumnWithIdentity,
        label_column: Optional[CategoricalColumnWithIdentity] = None,
        emb_size: int = 64,
        table_row_multiple: int = 1,
        quantized_table: bool = False,
        table_bits: int = 8,
        scale_col_groups: int = 1,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.uid_column, self.iid_column = uid_column, iid_column
        self.iids_column, self.label_column = iids_column, label_column
        self._set_format(emb_size, table_row_multiple, quantized_table, table_bits,
                         scale_col_groups)
        users = self._table_rows(uid_column.category_num)
        items = self._table_rows(iid_column.category_num)
        self.u_embeddings = Embedding(users, emb_size, device, generator)
        self._add_item_table("i_embeddings", "i_q", items, device, generator)
        self._add_item_table("implicit_i_embeddings", "implicit_i_q", items, device, generator)
        self.u_bias = Embedding(users, 1, device, generator)
        self.i_bias = Embedding(items, 1, device, generator)
        self.global_bias = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """``global_bias`` is 0, as the JAX package initialises it."""
        self.global_bias.zero_()

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        u_ids = self.uid_column.get_feature_data(batch)  # [B]
        i_ids = self.iid_column.get_feature_data(batch)  # [B] or [B, N]
        implicit_ids = self.iids_column.get_feature_data(batch)  # [B, H]

        valid = (implicit_ids > 0).to(torch.float32)
        implicit = self._vectors(batch, self.IMP_ROWS_KEY, implicit_ids,
                                 "implicit_i_embeddings", "implicit_i_q")  # [B, H, E]
        implicit = torch.sum(implicit * valid[..., None], dim=1)
        implicit = implicit / torch.sqrt(torch.sum(valid, dim=-1))[:, None]  # [B, E]

        u_vectors = self._vectors(batch, self.U_ROWS_KEY, u_ids, "u_embeddings")
        i_vectors = self._vectors(batch, self.I_ROWS_KEY, i_ids, "i_embeddings", "i_q")
        u_bias = self._vectors(batch, self.UB_ROWS_KEY, u_ids, "u_bias", width=1)[..., 0]
        i_bias = self._vectors(batch, self.IB_ROWS_KEY, i_ids, "i_bias", width=1)[..., 0]

        if i_ids.dim() == 1:
            prediction = (torch.sum((u_vectors + implicit) * i_vectors, dim=-1)
                          + u_bias + i_bias + self.global_bias)
            return prediction, label_target(self.label_column, batch)
        user_side = (u_vectors + implicit)[:, None, :]  # [B, 1, E]
        prediction = (torch.sum(user_side * i_vectors, dim=-1) + u_bias[:, None] + i_bias
                      + self.global_bias)
        return prediction, one_hot_first_target(prediction)

    # --- sparse and quantized trainer protocols ---

    def _ids(self, batch: Batch):
        return (self.uid_column.get_feature_data(batch), self.iid_column.get_feature_data(batch),
                self.iids_column.get_feature_data(batch))

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        u_ids, i_ids, implicit_ids = self._ids(batch)
        return {"u_embeddings/embedding": u_ids, "i_embeddings/embedding": i_ids,
                "implicit_i_embeddings/embedding": implicit_ids, "u_bias/embedding": u_ids,
                "i_bias/embedding": i_ids}

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        u_ids, i_ids, implicit_ids = self._ids(batch)
        quantized = self._quantized_format()
        return {
            "u": sharded_spec("u_embeddings/embedding", u_ids, self.U_ROWS_KEY),
            "i": sharded_spec(self._item_path("i_embeddings", "i_q"), i_ids, self.I_ROWS_KEY,
                              quantized),
            "imp": sharded_spec(self._item_path("implicit_i_embeddings", "implicit_i_q"),
                                implicit_ids, self.IMP_ROWS_KEY, quantized),
            "ub": sharded_spec("u_bias/embedding", u_ids, self.UB_ROWS_KEY),
            "ib": sharded_spec("i_bias/embedding", i_ids, self.IB_ROWS_KEY),
        }

    def quantized_table_spec(self, batch: Batch) -> Dict[str, dict]:
        """The two packed item tables, each salted on its own path; the user
        table and the biases train under the dense optimizer."""
        _, i_ids, implicit_ids = self._ids(batch)
        return {"i": self._quantized_spec("i_q", i_ids, self.I_ROWS_KEY),
                "imp": self._quantized_spec("implicit_i_q", implicit_ids, self.IMP_ROWS_KEY)}
