"""FunkSVD, plain matrix factorization (port of
``pytorchrec_tpu/models/funk_svd.py``): the score is ``dot(user, item)``.

The batch carries the user id ``[B]`` and the item ids ``[B]`` (point-wise,
target the label column) or ``[B, N]`` (candidates, positive first, target
one-hot-first). Parameters keep the flax names: ``u_embeddings.embedding``
and ``i_embeddings.embedding``, or with ``quantized_table`` the item table
as the packed byte-row buffer ``i_q`` (``models/base.py::PackedTablesModel``;
the user table stays f32). ``sharded_table_specs`` (the sparse trainer's
protocol) and ``quantized_table_spec`` (the quantized trainer's) name the
tables with their ids and batch keys, the JAX model's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

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


class FunkSVD(PackedTablesModel):
    U_ROWS_KEY = "__rows__u"
    I_ROWS_KEY = "__rows__i"

    def __init__(
        self,
        uid_column: CategoricalColumnWithIdentity,
        iid_column: CategoricalColumnWithIdentity,
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
        self.uid_column, self.iid_column, self.label_column = uid_column, iid_column, label_column
        self._set_format(emb_size, table_row_multiple, quantized_table, table_bits,
                         scale_col_groups)
        self.u_embeddings = Embedding(self._table_rows(uid_column.category_num), emb_size,
                                      device, generator)
        self._add_item_table("i_embeddings", "i_q", iid_column.category_num, device, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        u_ids = self.uid_column.get_feature_data(batch)  # [B]
        i_ids = self.iid_column.get_feature_data(batch)  # [B] or [B, N]
        u_vectors = self._vectors(batch, self.U_ROWS_KEY, u_ids, "u_embeddings")
        i_vectors = self._vectors(batch, self.I_ROWS_KEY, i_ids, "i_embeddings", "i_q")
        if i_ids.dim() == 1:
            return torch.sum(u_vectors * i_vectors, dim=-1), label_target(self.label_column, batch)
        prediction = torch.sum(u_vectors[:, None, :] * i_vectors, dim=-1)  # [B, N]
        return prediction, one_hot_first_target(prediction)

    # --- sparse and quantized trainer protocols ---

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {"u_embeddings/embedding": self.uid_column.get_feature_data(batch),
                "i_embeddings/embedding": self.iid_column.get_feature_data(batch)}

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        return {"u": sharded_spec("u_embeddings/embedding", self.uid_column.get_feature_data(batch),
                                  self.U_ROWS_KEY),
                "i": sharded_spec(self._item_path("i_embeddings", "i_q"),
                                  self.iid_column.get_feature_data(batch), self.I_ROWS_KEY,
                                  self._quantized_format())}

    def quantized_table_spec(self, batch: Batch) -> Dict[str, dict]:
        """The packed item table; the user table trains under the dense
        optimizer."""
        return {"i": self._quantized_spec("i_q", self.iid_column.get_feature_data(batch),
                                          self.I_ROWS_KEY)}
