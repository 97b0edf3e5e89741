"""SASRec, the self-attentive sequential recommender (port of
``pytorchrec_tpu/models/sasrec.py``).

The batch carries the candidate ids ``[B]`` or ``[B, N]``, the history
``[B, L]`` (0 = PAD after each row's ``his_len`` ids; column 0 always valid,
``ops/seq_utils.py``) and its length ``[B]``. The history's item rows plus
``p_embeddings`` at the reverse position ids run through ``num_layers``
encoder blocks (``ops/attention.py``: the global-max attention, ``W1``/``W2``,
dropout, the residual and flax's LayerNorm), are mean-pooled over the valid
positions, and the score is the pool's dot product with each candidate's
row. The target is the label column at either shape.

With ``share_layer_weights`` (the default, as the reference) one block,
``block_shared``, runs ``num_layers`` times: one submodule, so the state dict
holds each of its parameters once, as the flax tree does; otherwise the
blocks are ``block_0``, ``block_1``, and so on. ``p_embeddings``
(``[max_his_len + 1, E]``, read by a one-hot product, ``_position_rows``)
is a dense parameter under every trainer; the
item table is ``i_embeddings`` or the packed ``i_q``
(``models/base.py::SequenceItemModel``). The rowwise table lr the model
asks for is ``table_lr_hint`` (4e-3).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.models.base import Batch, Prediction, SequenceItemModel, label_target
from pytorchrec_tpu_torch.ops.attention import SASRecBlock, sasrec_encoder
from pytorchrec_tpu_torch.ops.embedding import Embedding
from pytorchrec_tpu_torch.ops.seq_utils import get_position_ids, get_valid_his_index
from pytorchrec_tpu_torch.utils.device import resolve_device


class SASRec(SequenceItemModel):
    I_ROWS_KEY = "__rows__sasrec_i"

    def __init__(
        self,
        iid_column: CategoricalColumnWithIdentity,
        his_column: CategoricalColumnWithIdentity,
        his_len_column: CategoricalColumnWithIdentity,
        label_column: Optional[CategoricalColumnWithIdentity] = None,
        emb_size: int = 64,
        max_his_len: int = 10,
        num_layers: int = 1,
        dropout: float = 0.2,
        share_layer_weights: bool = True,
        table_row_multiple: int = 1,
        quantized_table: bool = False,
        table_lr_hint: float = 4e-3,
        table_bits: int = 8,
        scale_col_groups: int = 1,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.iid_column, self.his_column = iid_column, his_column
        self.his_len_column, self.label_column = his_len_column, label_column
        self.max_his_len, self.num_layers = max_his_len, num_layers
        self.share_layer_weights = share_layer_weights
        # the rowwise-Adagrad table lr, absolute (``resolve_table_lr``)
        self.table_lr_hint = table_lr_hint
        self._set_format(emb_size, table_row_multiple, quantized_table, table_bits,
                         scale_col_groups)
        self._add_item_table("i_embeddings", "i_q", iid_column.category_num, device, generator)
        self.p_embeddings = Embedding(max_his_len + 1, emb_size, device, generator)
        names = ["block_shared"] if share_layer_weights else [f"block_{i}"
                                                              for i in range(num_layers)]
        for name in names:
            setattr(self, name, SASRecBlock(emb_size, dropout, device, generator))

    @property
    def blocks(self) -> List[SASRecBlock]:
        """The block of each layer, in order (one block ``num_layers`` times
        when shared)."""
        if self.share_layer_weights:
            return [self.block_shared] * self.num_layers
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def _position_rows(self, positions: torch.Tensor) -> torch.Tensor:
        """``p_embeddings``' rows at ``positions`` as a one-hot product, exact
        (each sum adds one row to zeros): its backward is one GEMM, a fixed
        order, where a gather's backward on the card sums the thousands of
        a batch's gradients that each of these few rows takes in no fixed
        order (``scripts/torch_embedding_determinism.py``)."""
        table = self.p_embeddings.embedding
        rows = torch.arange(table.shape[0], device=positions.device)
        return (positions[..., None] == rows).to(table.dtype) @ table

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        i_ids = self.iid_column.get_feature_data(batch)  # [B] or [B, N]
        his_ids = self.his_column.get_feature_data(batch)  # [B, L]
        his_len = self.his_len_column.get_feature_data(batch)  # [B]
        valid_his = get_valid_his_index(his_ids)
        pointwise = i_ids.dim() == 1
        if pointwise:
            i_ids = i_ids[:, None]
        i_vectors, his_vectors = self._candidates_and_history(batch, i_ids, his_ids)
        his_vectors = his_vectors + self._position_rows(get_position_ids(valid_his, his_len))
        his_vector = sasrec_encoder(his_vectors, valid_his, his_len, self.blocks, train=train,
                                    generator=generator)  # [B, E]
        prediction = torch.sum(his_vector[:, None, :] * i_vectors, dim=-1)  # [B, N]
        if pointwise:
            prediction = prediction[:, 0]
        return prediction, label_target(self.label_column, batch)
