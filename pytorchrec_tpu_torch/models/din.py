"""DIN, the Deep Interest Network (port of ``pytorchrec_tpu/models/din.py``):
attention pooling of a user's behaviour sequence against each candidate.

The batch carries the user id ``[B]``, the candidate ids ``[B]`` (point-wise)
or ``[B, N]`` (positive first), and the history ``[B, S]`` (0 = PAD; column
0 always counts as valid, ``ops/seq_utils.py``). The parameters keep the flax
names, so converted weights load 1:1 (``utils/convert.py``):

* ``u_embeddings.embedding [V_user, E]`` f32;
* ``i_embeddings.embedding [V_item, E]`` f32, or with ``quantized_table`` the
  item table as int8/int4 packed ``q || scale || acc`` byte rows, the buffer
  ``i_q [V_item, W]`` u8 (``ops/quantized_packed.py``); the user table stays
  f32;
* ``attention.w0, b0, ...`` (``ops/attention.py``), the MLP over
  ``[user, interest, item, interest * item]`` (``mlp``, relu) and a bias-free
  ``head``.

Rows injection: ``sharded_table_specs`` (the sparse trainer's protocol) and
``quantized_table_spec`` (the quantized trainer's) name the tables with their
ids and batch keys. The item table serves the candidates and the history in
one gather, candidates first, then history (``_item_gather_ids``); the
forward splits injected rows in that order.
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
from pytorchrec_tpu_torch.ops.attention import DINAttentionPool
from pytorchrec_tpu_torch.ops.embedding import Embedding, normal_init
from pytorchrec_tpu_torch.ops.kernels.quantize import quantize_rows
from pytorchrec_tpu_torch.ops.mlp import MLP, linear
from pytorchrec_tpu_torch.ops.quantized_packed import pack_quantized_table, packed_gather_dequant
from pytorchrec_tpu_torch.ops.seq_utils import get_valid_his_index
from pytorchrec_tpu_torch.utils.device import resolve_device


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class DIN(RecModel):
    # batch keys of trainer-gathered rows: the user table, and the item table's
    # candidate rows followed by its history rows
    U_ROWS_KEY = "__rows__din_u"
    I_ROWS_KEY = "__rows__din_i"

    def __init__(
        self,
        uid_column: CategoricalColumnWithIdentity,
        iid_column: CategoricalColumnWithIdentity,
        his_column: CategoricalColumnWithIdentity,
        his_len_column: CategoricalColumnWithIdentity,
        label_column: Optional[CategoricalColumnWithIdentity] = None,
        emb_size: int = 32,
        att_hidden_units: Sequence[int] = (80, 40),
        mlp_layers: Sequence[int] = (200, 80),
        dropout: float = 0.0,
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
        self.uid_column, self.iid_column = uid_column, iid_column
        self.his_column, self.his_len_column = his_column, his_len_column
        self.label_column = label_column
        self.emb_size = emb_size
        self.table_row_multiple = table_row_multiple
        self.quantized_table = quantized_table
        # the rowwise-Adagrad table lr, absolute (``resolve_table_lr``)
        self.table_lr_hint = table_lr_hint
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
        self.attention = DINAttentionPool(emb_size, att_hidden_units, device=device,
                                          generator=generator)
        self.mlp = MLP(4 * emb_size, tuple(mlp_layers), activation="relu", dropout=dropout,
                       device=device, generator=generator)
        self.head = linear(self.mlp.out_features, 1, use_bias=False, device=device,
                           generator=generator)

    @property
    def has_quantized_table(self) -> bool:
        return self.quantized_table

    def _item_vectors(self, ids: torch.Tensor) -> torch.Tensor:
        """``[ids..., E]`` f32 from the item table (f32 or packed quantized)."""
        if self.quantized_table:
            return packed_gather_dequant(self.i_q, ids, self.emb_size, self.table_bits,
                                         self.scale_col_groups)
        return self.i_embeddings(ids)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        u_ids = self.uid_column.get_feature_data(batch)  # [B]
        i_ids = self.iid_column.get_feature_data(batch)  # [B] or [B, N]
        his_ids = self.his_column.get_feature_data(batch)  # [B, S]
        valid_his = get_valid_his_index(his_ids)
        pointwise = i_ids.dim() == 1
        if pointwise:
            i_ids = i_ids[:, None]

        u_rows = batch.get(self.U_ROWS_KEY)
        i_rows = batch.get(self.I_ROWS_KEY)
        u_vectors = (u_rows.reshape(*u_ids.shape, self.emb_size) if u_rows is not None
                     else self.u_embeddings(u_ids))
        if i_rows is not None:
            rows = i_rows.reshape(-1, self.emb_size)
            n_cand = i_ids.shape[0] * i_ids.shape[1]
            i_vectors = rows[:n_cand].reshape(*i_ids.shape, self.emb_size)
            his_vectors = rows[n_cand:].reshape(*his_ids.shape, self.emb_size)
        else:
            i_vectors = self._item_vectors(i_ids)  # [B, N, E]
            his_vectors = self._item_vectors(his_ids)  # [B, S, E]

        interest = self.attention(his_vectors, i_vectors, valid_his)  # [B, N, E]
        u_b = u_vectors[:, None, :].expand_as(interest)
        feats = torch.cat([u_b, interest, i_vectors, interest * i_vectors], dim=-1)  # [B, N, 4E]
        prediction = self.head(self.mlp(feats, train=train, generator=generator))[..., 0]
        if pointwise:
            return prediction[:, 0], label_target(self.label_column, batch)
        return prediction, one_hot_first_target(prediction)

    # --- sparse and quantized trainer protocols ---

    def _item_gather_ids(self, batch: Batch) -> torch.Tensor:
        """Candidate then history ids, flat, in the order ``forward`` splits
        the injected rows: ``[B*N candidates | B*S history]``."""
        i_ids = self.iid_column.get_feature_data(batch)
        if i_ids.dim() == 1:
            i_ids = i_ids[:, None]
        his_ids = self.his_column.get_feature_data(batch)
        return torch.cat([i_ids.reshape(-1), his_ids.reshape(-1)])

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Sparse-trainer protocol: table path -> the ids that gather from it."""
        return {"u_embeddings/embedding": self.uid_column.get_feature_data(batch),
                "i_embeddings/embedding": self._item_gather_ids(batch)}

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        """Rows-injection protocol: each table's flax path, ids and batch key.
        With ``quantized_table`` the item spec names the packed byte-row leaf
        ``i_q`` and carries its format under ``"quantized"``."""
        i_spec = {"ids": self._item_gather_ids(batch), "rows_key": self.I_ROWS_KEY}
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
        touched byte rows; the user table and the dense nets train under the
        dense optimizer."""
        if not self.quantized_table:
            raise ValueError("QuantizedEmbeddingTrainer needs DIN(quantized_table=True)")
        return {"i": {"q": "i_q", "scale": None, "ids": self._item_gather_ids(batch),
                      "rows_key": self.I_ROWS_KEY, "bits": self.table_bits,
                      "col_groups": self.scale_col_groups, "packed": True,
                      "emb_size": self.emb_size}}
