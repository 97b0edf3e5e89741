"""GRU4Rec, an RNN ranker over a user's item history (port of
``pytorchrec_tpu/models/gru4rec.py``).

The batch carries the candidate ids ``[B]`` or ``[B, N]``, the history
``[B, S]`` (0 = PAD after each row's ``his_len`` ids) and its length
``[B]``. The history's rows run through ``rnn``, the masked GRU
(``ops/gru.py``, the JAX package's masked scan, no cuDNN), whose final state
goes through the bias-free ``out`` to E; the score is its dot product with
each candidate's row. The target is the label column at either shape.
Parameters keep the flax names (``rnn.w_ih [E, 3H]``, ``rnn.w_hh``,
``rnn.b_ih``, ``rnn.b_hh`` untransposed, ``out.weight``), and the item table
is ``i_embeddings`` or the packed ``i_q`` (``models/base.py::
SequenceItemModel``: candidates and history in one gather). The rowwise
table lr the model asks for is ``table_lr_hint`` (2e-2).
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.models.base import Batch, Prediction, SequenceItemModel, label_target
from pytorchrec_tpu_torch.ops.gru import MaskedGRU
from pytorchrec_tpu_torch.ops.mlp import linear
from pytorchrec_tpu_torch.utils.device import resolve_device


class GRU4Rec(SequenceItemModel):
    I_ROWS_KEY = "__rows__gru4rec_i"

    def __init__(
        self,
        iid_column: CategoricalColumnWithIdentity,
        his_column: CategoricalColumnWithIdentity,
        his_len_column: CategoricalColumnWithIdentity,
        label_column: Optional[CategoricalColumnWithIdentity] = None,
        emb_size: int = 64,
        hidden_size: int = 64,
        table_row_multiple: int = 1,
        quantized_table: bool = False,
        table_lr_hint: float = 2e-2,
        table_bits: int = 8,
        scale_col_groups: int = 1,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.iid_column, self.his_column = iid_column, his_column
        self.his_len_column, self.label_column = his_len_column, label_column
        self.hidden_size = hidden_size
        # the rowwise-Adagrad table lr, absolute (``resolve_table_lr``)
        self.table_lr_hint = table_lr_hint
        self._set_format(emb_size, table_row_multiple, quantized_table, table_bits,
                         scale_col_groups)
        self._add_item_table("i_embeddings", "i_q", iid_column.category_num, device, generator)
        self.rnn = MaskedGRU(emb_size, hidden_size, device, generator)
        self.out = linear(hidden_size, emb_size, use_bias=False, device=device,
                          generator=generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        i_ids = self.iid_column.get_feature_data(batch)  # [B] or [B, N]
        his_ids = self.his_column.get_feature_data(batch)  # [B, S]
        his_len = self.his_len_column.get_feature_data(batch)  # [B]
        pointwise = i_ids.dim() == 1
        if pointwise:
            i_ids = i_ids[:, None]
        i_vectors, his_vectors = self._candidates_and_history(batch, i_ids, his_ids)
        rnn_vector = self.out(self.rnn(his_vectors, his_len))  # [B, E]
        prediction = torch.sum(rnn_vector[:, None, :] * i_vectors, dim=-1)  # [B, N]
        if pointwise:
            prediction = prediction[:, 0]
        return prediction, label_target(self.label_column, batch)
