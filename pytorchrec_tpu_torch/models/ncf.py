"""NCF, NeuMF (port of ``pytorchrec_tpu/models/ncf.py``): a GMF
elementwise product beside an MLP tower, joined by a bias-free linear head.

The batch carries the user id ``[B]`` and the item ids ``[B]`` or ``[B, N]``
(positive first). User rows are gathered once a row and broadcast over the
N candidates. Parameters keep the flax names: ``mf_u_embeddings``,
``mlp_u_embeddings``, ``mf_i_embeddings`` and ``mlp_i_embeddings`` (or with
``quantized_table`` the two item tables as the packed byte-row buffers
``mf_i_q`` and ``mlp_i_q``), the tower ``mlp`` (``MLP(2E, layers)``, relu,
dropout) and ``prediction_head`` (kernel ``[E + layers[-1], 1]``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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
from pytorchrec_tpu_torch.ops.mlp import MLP, linear
from pytorchrec_tpu_torch.utils.device import resolve_device


class NCF(PackedTablesModel):
    MF_U_ROWS_KEY = "__rows__ncf_mf_u"
    MF_I_ROWS_KEY = "__rows__ncf_mf_i"
    MLP_U_ROWS_KEY = "__rows__ncf_mlp_u"
    MLP_I_ROWS_KEY = "__rows__ncf_mlp_i"

    def __init__(
        self,
        uid_column: CategoricalColumnWithIdentity,
        iid_column: CategoricalColumnWithIdentity,
        label_column: Optional[CategoricalColumnWithIdentity] = None,
        emb_size: int = 64,
        layers: Sequence[int] = (64,),
        dropout: float = 0.2,
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
        users = self._table_rows(uid_column.category_num)
        self.mf_u_embeddings = Embedding(users, emb_size, device, generator)
        self.mlp_u_embeddings = Embedding(users, emb_size, device, generator)
        self._add_item_table("mf_i_embeddings", "mf_i_q", iid_column.category_num, device,
                             generator)
        self._add_item_table("mlp_i_embeddings", "mlp_i_q", iid_column.category_num, device,
                             generator)
        self.mlp = MLP(2 * emb_size, tuple(layers), activation="relu", dropout=dropout,
                       device=device, generator=generator)
        self.prediction_head = linear(emb_size + self.mlp.out_features, 1, use_bias=False,
                                      device=device, generator=generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        u_ids = self.uid_column.get_feature_data(batch)  # [B]
        i_ids = self.iid_column.get_feature_data(batch)  # [B] or [B, N]
        pointwise = i_ids.dim() == 1
        if pointwise:
            i_ids = i_ids[:, None]

        mf_u = self._vectors(batch, self.MF_U_ROWS_KEY, u_ids, "mf_u_embeddings")[:, None, :]
        mlp_u = self._vectors(batch, self.MLP_U_ROWS_KEY, u_ids, "mlp_u_embeddings")[:, None, :]
        mf_i = self._vectors(batch, self.MF_I_ROWS_KEY, i_ids, "mf_i_embeddings", "mf_i_q")
        mlp_i = self._vectors(batch, self.MLP_I_ROWS_KEY, i_ids, "mlp_i_embeddings", "mlp_i_q")

        mf_vector = mf_u * mf_i  # [B, N, E]
        mlp_vector = torch.cat([mlp_u.expand_as(mlp_i), mlp_i], dim=-1)  # [B, N, 2E]
        mlp_vector = self.mlp(mlp_vector, train=train, generator=generator)
        prediction = self.prediction_head(torch.cat([mf_vector, mlp_vector], dim=-1))[..., 0]
        if pointwise:
            return prediction[:, 0], label_target(self.label_column, batch)
        return prediction, one_hot_first_target(prediction)

    # --- sparse and quantized trainer protocols ---

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        u_ids = self.uid_column.get_feature_data(batch)
        i_ids = self.iid_column.get_feature_data(batch)
        return {"mf_u_embeddings/embedding": u_ids, "mlp_u_embeddings/embedding": u_ids,
                "mf_i_embeddings/embedding": i_ids, "mlp_i_embeddings/embedding": i_ids}

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        u_ids = self.uid_column.get_feature_data(batch)
        i_ids = self.iid_column.get_feature_data(batch)
        quantized = self._quantized_format()
        return {
            "mf_u": sharded_spec("mf_u_embeddings/embedding", u_ids, self.MF_U_ROWS_KEY),
            "mlp_u": sharded_spec("mlp_u_embeddings/embedding", u_ids, self.MLP_U_ROWS_KEY),
            "mf_i": sharded_spec(self._item_path("mf_i_embeddings", "mf_i_q"), i_ids,
                                 self.MF_I_ROWS_KEY, quantized),
            "mlp_i": sharded_spec(self._item_path("mlp_i_embeddings", "mlp_i_q"), i_ids,
                                  self.MLP_I_ROWS_KEY, quantized),
        }

    def quantized_table_spec(self, batch: Batch) -> Dict[str, dict]:
        """The two packed item tables; the user tables and the tower train
        under the dense optimizer."""
        i_ids = self.iid_column.get_feature_data(batch)
        return {"mf_i": self._quantized_spec("mf_i_q", i_ids, self.MF_I_ROWS_KEY),
                "mlp_i": self._quantized_spec("mlp_i_q", i_ids, self.MLP_I_ROWS_KEY)}
