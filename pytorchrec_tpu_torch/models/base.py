"""Model base (port of ``pytorchrec_tpu/models/base.py``).

Every model takes feature-column objects and hyper-parameters at
construction and maps a batch dict to ``(prediction, target)``:

* point-wise rows: ``prediction [B]``, target = the label column as float
  (None when the batch carries no label, as when serving);
* candidate rows (``[B, N]``, positive first): ``prediction [B, N]``,
  target = one-hot-first.

``PackedTablesModel`` and ``SequenceItemModel`` hold what the zoo's models
(FunkSVD, SVD++, NCF, GRU4Rec, SASRec) share: f32 or packed quantized item
tables, their rows-injection specs (``sharded_spec``, ``quantized_spec``)
and, for the sequence models, one gather of candidates and history.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from pytorchrec_tpu_torch.ops.embedding import Embedding
from pytorchrec_tpu_torch.ops.quantized_packed import packed_gather_dequant, packed_table_init

Batch = Dict[str, Any]
Prediction = Tuple[torch.Tensor, Optional[torch.Tensor]]


def round_up(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple`` (a table's rows)."""
    return -(-n // multiple) * multiple


def sharded_spec(path: str, ids: torch.Tensor, rows_key: str,
                 quantized: Optional[dict] = None) -> dict:
    """One table of the rows-injection protocol (``sharded_table_specs``):
    its flax path, the ids it gathers, the batch key of the injected rows
    and, for a packed quantized table, its format (``emb_size``, ``bits``,
    ``col_groups``)."""
    spec = {"path": path, "ids": ids, "rows_key": rows_key}
    if quantized is not None:
        spec["quantized"] = dict(quantized)
    return spec


def quantized_spec(q: str, ids: torch.Tensor, rows_key: str, emb_size: int, bits: int,
                   col_groups: int) -> dict:
    """One packed table of the quantized trainer's protocol
    (``quantized_table_spec``): the u8 buffer ``q``, the ids it gathers and
    the batch key of the injected dequantized rows."""
    return {"q": q, "scale": None, "ids": ids, "rows_key": rows_key, "bits": bits,
            "col_groups": col_groups, "packed": True, "emb_size": emb_size}


def one_hot_first_target(prediction: torch.Tensor) -> torch.Tensor:
    """Ranking target: ``[B, N]`` zeros with column 0 = 1 (the positive)."""
    target = torch.zeros_like(prediction, dtype=torch.float32)
    target[:, 0] = 1.0
    return target


def label_target(label_column, batch: Batch) -> Optional[torch.Tensor]:
    target = label_column.get_feature_data(batch) if label_column is not None else None
    if target is not None:
        target = torch.as_tensor(target).to(torch.float32)
    return target


class RecModel(nn.Module):
    """Base class for all rec models: ``forward(batch, train) -> (pred, target)``."""

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:  # pragma: no cover
        """``generator`` feeds dropout when ``train`` is True."""
        raise NotImplementedError

    @property
    def has_quantized_table(self) -> bool:
        """Whether a table is kept as quantized byte rows, which train only
        under ``QuantizedEmbeddingTrainer``."""
        return False


class PackedTablesModel(RecModel):
    """A model whose item tables are f32 ``Embedding``s, or with
    ``quantized_table`` packed int8/int4 ``q || scale || acc || staging``
    byte-row buffers (``ops/quantized_packed.py``), each trained by the
    trainer that owns its layout through rows injection: the trainer gathers
    a table's rows and passes them under the table's batch key, and the
    forward reads them there in place of its own gather."""

    def _set_format(self, emb_size: int, table_row_multiple: int, quantized_table: bool,
                    table_bits: int, scale_col_groups: int) -> None:
        self.emb_size = emb_size
        self.table_row_multiple = table_row_multiple
        self.quantized_table = quantized_table
        self.table_bits = table_bits
        self.scale_col_groups = scale_col_groups

    @property
    def has_quantized_table(self) -> bool:
        return self.quantized_table

    def _table_rows(self, vocab: int) -> int:
        return round_up(vocab, self.table_row_multiple)

    def _add_item_table(self, name: str, q_name: str, vocab: int, device,
                        generator: Optional[torch.Generator]) -> None:
        """``name`` (an f32 ``Embedding``), or with ``quantized_table`` the
        u8 buffer ``q_name``."""
        rows = self._table_rows(vocab)
        if self.quantized_table:
            self.register_buffer(q_name, packed_table_init(
                rows, self.emb_size, self.table_bits, self.scale_col_groups, device, generator))
        else:
            setattr(self, name, Embedding(rows, self.emb_size, device, generator))

    def _item_path(self, name: str, q_name: str) -> str:
        """The flax path of an item table: the u8 leaf or ``<name>/embedding``."""
        return q_name if self.quantized_table else f"{name}/embedding"

    def _quantized_format(self) -> Optional[dict]:
        if not self.quantized_table:
            return None
        return {"emb_size": self.emb_size, "bits": self.table_bits,
                "col_groups": self.scale_col_groups}

    def _quantized_spec(self, q_name: str, ids: torch.Tensor, rows_key: str) -> dict:
        if not self.quantized_table:
            raise ValueError(f"QuantizedEmbeddingTrainer needs "
                             f"{type(self).__name__}(quantized_table=True)")
        return quantized_spec(q_name, ids, rows_key, **self._quantized_format())

    def _vectors(self, batch: Batch, rows_key: str, ids: torch.Tensor, name: str,
                 q_name: Optional[str] = None, width: Optional[int] = None) -> torch.Tensor:
        """``[ids..., width]`` rows of a table: the injected rows under
        ``rows_key`` where the batch has them, else the model's own gather
        (from the packed buffer ``q_name`` with ``quantized_table``)."""
        width = self.emb_size if width is None else width
        rows = batch.get(rows_key)
        if rows is not None:
            return rows.reshape(*ids.shape, width)
        if q_name is not None and self.quantized_table:
            return packed_gather_dequant(getattr(self, q_name), ids, self.emb_size,
                                         self.table_bits, self.scale_col_groups)
        return getattr(self, name)(ids)


class SequenceItemModel(PackedTablesModel):
    """A sequence model with one item table (``i_embeddings`` or the packed
    ``i_q``) that serves the candidates ``iid_column`` and the history
    ``his_column`` in one gather, candidates first (``_item_gather_ids``);
    the forward splits injected rows, under the subclass's ``I_ROWS_KEY``,
    in that order."""

    def _item_gather_ids(self, batch: Batch) -> torch.Tensor:
        """``[B*N candidates | B*S history]`` ids, flat."""
        i_ids = self.iid_column.get_feature_data(batch)
        if i_ids.dim() == 1:
            i_ids = i_ids[:, None]
        his_ids = self.his_column.get_feature_data(batch)
        return torch.cat([i_ids.reshape(-1), his_ids.reshape(-1)])

    def _candidates_and_history(self, batch: Batch, i_ids: torch.Tensor,
                                his_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``([B, N, E], [B, S, E])`` item rows: the injected ones, split
        candidates first, or the model's own gathers."""
        rows = batch.get(self.I_ROWS_KEY)
        if rows is None:
            return (self._vectors(batch, self.I_ROWS_KEY, i_ids, "i_embeddings", "i_q"),
                    self._vectors(batch, self.I_ROWS_KEY, his_ids, "i_embeddings", "i_q"))
        rows = rows.reshape(-1, self.emb_size)
        n_cand = i_ids.shape[0] * i_ids.shape[1]
        return (rows[:n_cand].reshape(*i_ids.shape, self.emb_size),
                rows[n_cand:].reshape(*his_ids.shape, self.emb_size))

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {"i_embeddings/embedding": self._item_gather_ids(batch)}

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        return {"i": sharded_spec(self._item_path("i_embeddings", "i_q"),
                                  self._item_gather_ids(batch), self.I_ROWS_KEY,
                                  self._quantized_format())}

    def quantized_table_spec(self, batch: Batch) -> Dict[str, dict]:
        """The packed item table; the rest trains under the dense
        optimizer."""
        return {"i": self._quantized_spec("i_q", self._item_gather_ids(batch), self.I_ROWS_KEY)}
