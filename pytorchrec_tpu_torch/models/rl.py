"""Value-based RL ranking family: DQN, DEERS, LSRL and the LSRL ablations
(port of ``pytorchrec_tpu/models/rl.py``).

A Q-network scores actions (candidate items) in a state (the user's recent
positive, and negative, items): ``q_values(batch)`` over the batch's
candidates ``iid`` (``[B]`` or ``[B, N]``) in its state, and
``next_forward(batch)`` over the next candidates ``rl_sample`` ``[B, N]`` in
the next state (the JAX package's ``forward`` and ``next_forward``). As
every model of the port, ``forward(batch, train)`` returns ``(prediction,
target)``: the Q values and, for ``[B, N]`` candidate rows, the
one-hot-first ranking target (None for ``[B]``), which the trainer's scorer
and ``evaluate`` read.

* ``DQNQNet``: a masked GRU over the state's item rows, a dense ``out`` to
  E, and ``Q = sum(h * item, -1)``;
* ``BranchQNet``: long (user row and item row), pos-short and neg-short
  (each a masked GRU over its state, then an MLP over ``hidden || item``)
  branches, fused by a dense layer and scored by a bias-free ``prediction``
  (``make_deers_qnet``, ``make_lsrl_qnet`` and the four ablations select
  the branches). Its layers drop values at ``dropout`` (0.2) when training.

``ValueRLModel`` holds one Q-network and the Bellman target: ``apply(batch,
target, train)`` returns ``(main_q, target_q)``, ``main_q`` the network's Q
of the batch's actions and ``target_q = reward + gamma * max(Q'(s', a'))``,
computed under ``torch.no_grad()`` by ``target``, a second instance of the
Q-network (``make_target``: no grad, eval mode, so no dropout in it, as
JAX's ``train=False``), which the trainer copies the network into every
``update_freq`` steps.

Tables and rows injection, as the zoo's (``models/base.py``): the item
table is ``i_embedding`` (DQN) or ``i_embeddings`` (the branch networks), or
with ``quantized_table`` the packed u8 ``i_q``; the long branch adds
``u_embeddings``. The eval network's gathers (candidates, then each active
state's history, one flat block) are named by ``sharded_table_specs``, whose
rows the sparse trainer injects under ``I_ROWS_KEY`` (``U_ROWS_KEY`` for
the user rows); the next-step gathers by ``sharded_target_specs``, under
``N_ROWS_KEY`` (DQN) or ``N_I_ROWS_KEY`` and ``N_U_ROWS_KEY``. Without
injected rows each network gathers from its own tables. The masked GRU
never permutes rows, so the reference DEERS/LSRL's sort/unsort mis-pairing
is fixed, as in the JAX package.

Parameters keep the flax names: ``i_embedding/embedding``,
``i_embeddings/embedding``, ``u_embeddings/embedding``, ``i_q``,
``rnn``/``pos_rnn``/``neg_rnn`` (``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``),
``out``, ``long_mlp``/``pos_mlp``/``neg_mlp`` (``Dense_<i>/Dense_0``),
``fuse`` (``Dense_0``) and ``prediction``.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.models.base import (
    Batch,
    PackedTablesModel,
    Prediction,
    one_hot_first_target,
    sharded_spec,
)
from pytorchrec_tpu_torch.ops.embedding import Embedding
from pytorchrec_tpu_torch.ops.gru import MaskedGRU
from pytorchrec_tpu_torch.ops.mlp import MLP, Dense, linear
from pytorchrec_tpu_torch.ops.quantized_packed import packed_gather_dequant
from pytorchrec_tpu_torch.utils.device import resolve_device


def _split_rows(rows: torch.Tensor, emb: int, *shapes) -> Tuple[torch.Tensor, ...]:
    """An injected flat block of rows cut into ``[*shape, emb]`` pieces, in
    order."""
    rows = rows.reshape(-1, emb)
    out, offset = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        out.append(rows[offset:offset + n].reshape(*shape, emb))
        offset += n
    return tuple(out)


class QNet(PackedTablesModel):
    """Q(s, a) over the current state and over the next state's candidates."""

    def q_values(self, batch: Batch, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def next_forward(self, batch: Batch) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        q = self.q_values(batch, train, generator)
        return q, (one_hot_first_target(q) if q.dim() == 2 else None)

    def _item_vec(self, ids: torch.Tensor) -> torch.Tensor:
        """The network's own gather of item rows (dequantized from ``i_q``
        with ``quantized_table``)."""
        if self.quantized_table:
            return packed_gather_dequant(self.i_q, ids, self.emb_size, self.table_bits,
                                         self.scale_col_groups)
        return getattr(self, self.ITEM_TABLE)(ids)

    def _item_spec(self, ids: torch.Tensor, rows_key: str) -> dict:
        return sharded_spec(self._item_path(self.ITEM_TABLE, "i_q"), ids, rows_key,
                            self._quantized_format())

    def injection_specs(self, batch: Batch) -> Dict[str, dict]:
        return self.sharded_table_specs(batch)


class DQNQNet(QNet):
    """GRU state encoder and dot-product Q (reference model/DQN.py:12-93)."""

    ITEM_TABLE = "i_embedding"
    I_ROWS_KEY = "__rows__dqn_i"
    N_ROWS_KEY = "__rows__dqn_i_next"

    def __init__(
        self,
        iid_column: CategoricalColumnWithIdentity,
        state_column: CategoricalColumnWithIdentity,
        state_len_column: CategoricalColumnWithIdentity,
        next_state_column: CategoricalColumnWithIdentity,
        next_state_len_column: CategoricalColumnWithIdentity,
        rl_sample_column: CategoricalColumnWithIdentity,
        emb_size: int = 64,
        hidden_size: int = 64,
        table_row_multiple: int = 1,
        quantized_table: bool = False,
        table_bits: int = 8,
        scale_col_groups: int = 1,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.iid_column, self.state_column = iid_column, state_column
        self.state_len_column = state_len_column
        self.next_state_column = next_state_column
        self.next_state_len_column = next_state_len_column
        self.rl_sample_column = rl_sample_column
        self.hidden_size = hidden_size
        self._set_format(emb_size, table_row_multiple, quantized_table, table_bits,
                         scale_col_groups)
        self._add_item_table("i_embedding", "i_q", iid_column.category_num, device, generator)
        self.rnn = MaskedGRU(emb_size, hidden_size, device, generator)
        self.out = linear(hidden_size, emb_size, device=device, generator=generator)

    def _encode(self, state_vectors: torch.Tensor, state_len: torch.Tensor) -> torch.Tensor:
        return self.out(self.rnn(state_vectors, state_len))  # [B, E]

    def q_values(self, batch: Batch, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        i_ids = self.iid_column.get_feature_data(batch)  # [B] or [B, N]
        state_ids = self.state_column.get_feature_data(batch)
        state_len = self.state_len_column.get_feature_data(batch)
        squeeze = i_ids.dim() == 1
        i2 = i_ids[:, None] if squeeze else i_ids
        rows = batch.get(self.I_ROWS_KEY)
        if rows is not None:
            i_vectors, state_vectors = _split_rows(rows, self.emb_size, i2.shape,
                                                   state_ids.shape)
        else:
            i_vectors, state_vectors = self._item_vec(i2), self._item_vec(state_ids)
        rnn_vector = self._encode(state_vectors, state_len)
        q = torch.sum(rnn_vector[:, None, :] * i_vectors, dim=-1)  # [B, N]
        return q[:, 0] if squeeze else q

    def next_forward(self, batch: Batch) -> torch.Tensor:
        next_i_ids = self.rl_sample_column.get_feature_data(batch)  # [B, N]
        next_state_ids = self.next_state_column.get_feature_data(batch)
        next_state_len = self.next_state_len_column.get_feature_data(batch)
        rows = batch.get(self.N_ROWS_KEY)
        if rows is not None:
            next_i_vectors, state_vectors = _split_rows(rows, self.emb_size, next_i_ids.shape,
                                                        next_state_ids.shape)
        else:
            next_i_vectors = self._item_vec(next_i_ids)
            state_vectors = self._item_vec(next_state_ids)
        rnn_vector = self._encode(state_vectors, next_state_len)
        return torch.sum(rnn_vector[:, None, :] * next_i_vectors, dim=-1)  # [B, N]

    def _forward_gather_ids(self, batch: Batch) -> torch.Tensor:
        i_ids = self.iid_column.get_feature_data(batch)
        state_ids = self.state_column.get_feature_data(batch)
        return torch.cat([i_ids.reshape(-1), state_ids.reshape(-1)])

    def _next_gather_ids(self, batch: Batch) -> torch.Tensor:
        next_i = self.rl_sample_column.get_feature_data(batch)
        next_s = self.next_state_column.get_feature_data(batch)
        return torch.cat([next_i.reshape(-1), next_s.reshape(-1)])

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The eval network's forward gathers on the item table."""
        return {"i_embedding/embedding": self._forward_gather_ids(batch)}

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        return {"i": self._item_spec(self._forward_gather_ids(batch), self.I_ROWS_KEY)}

    def sharded_target_specs(self, batch: Batch) -> Dict[str, dict]:
        """The target network's next-step gathers: the same table, its own
        batch key."""
        return {"i": self._item_spec(self._next_gather_ids(batch), self.N_ROWS_KEY)}


class BranchQNet(QNet):
    """Composable long / pos-short / neg-short Q-network: DEERS (pos and
    neg, DEERS.py:13-105), LSRL (all three, LSRL.py:16-121) and the four
    LSRL ablations (LSRL_*.py) by their branch toggles."""

    ITEM_TABLE = "i_embeddings"
    I_ROWS_KEY = "__rows__branchq_i"
    U_ROWS_KEY = "__rows__branchq_u"
    N_I_ROWS_KEY = "__rows__branchq_i_next"
    N_U_ROWS_KEY = "__rows__branchq_u_next"

    def __init__(
        self,
        iid_column: CategoricalColumnWithIdentity,
        pos_state_column: CategoricalColumnWithIdentity,
        pos_state_len_column: CategoricalColumnWithIdentity,
        pos_next_state_column: CategoricalColumnWithIdentity,
        pos_next_state_len_column: CategoricalColumnWithIdentity,
        rl_sample_column: CategoricalColumnWithIdentity,
        uid_column: Optional[CategoricalColumnWithIdentity] = None,
        neg_state_column: Optional[CategoricalColumnWithIdentity] = None,
        neg_state_len_column: Optional[CategoricalColumnWithIdentity] = None,
        neg_next_state_column: Optional[CategoricalColumnWithIdentity] = None,
        neg_next_state_len_column: Optional[CategoricalColumnWithIdentity] = None,
        use_long: bool = False,
        use_pos: bool = True,
        use_neg: bool = False,
        emb_size: int = 64,
        hidden_size: int = 64,
        dropout: float = 0.2,
        table_row_multiple: int = 1,
        quantized_table: bool = False,
        table_bits: int = 8,
        scale_col_groups: int = 1,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not (use_long or use_pos or use_neg):
            raise ValueError("at least one branch required")
        if use_long and uid_column is None:
            raise ValueError("the long branch needs uid_column")
        device = resolve_device(device)
        self.iid_column, self.uid_column = iid_column, uid_column
        self.pos_cols = (pos_state_column, pos_state_len_column)
        self.pos_next_cols = (pos_next_state_column, pos_next_state_len_column)
        self.neg_cols = (neg_state_column, neg_state_len_column)
        self.neg_next_cols = (neg_next_state_column, neg_next_state_len_column)
        self.rl_sample_column = rl_sample_column
        self.use_long, self.use_pos, self.use_neg = use_long, use_pos, use_neg
        self.hidden_size = hidden_size
        self._set_format(emb_size, table_row_multiple, quantized_table, table_bits,
                         scale_col_groups)
        self._add_item_table("i_embeddings", "i_q", iid_column.category_num, device, generator)
        e, layers = emb_size, (emb_size,) * 3
        mlp = dict(activation="relu", dropout=dropout, device=device, generator=generator)
        if use_long:
            self.u_embeddings = Embedding(self._table_rows(uid_column.category_num), e, device,
                                          generator)
            self.long_mlp = MLP(2 * e, layers, **mlp)
        if use_pos:
            self.pos_rnn = MaskedGRU(e, hidden_size, device, generator)
            self.pos_mlp = MLP(hidden_size + e, layers, **mlp)
        if use_neg:
            self.neg_rnn = MaskedGRU(e, hidden_size, device, generator)
            self.neg_mlp = MLP(hidden_size + e, layers, **mlp)
        branches = int(use_long) + int(use_pos) + int(use_neg)
        self.fuse = Dense(branches * e, e, **mlp)
        self.prediction = linear(e, 1, use_bias=False, device=device, generator=generator)

    def _score(self, batch: Batch, i_ids: torch.Tensor, pos_cols, neg_cols, train: bool,
               generator: Optional[torch.Generator], rows_key: str,
               u_rows_key: str) -> torch.Tensor:
        squeeze = i_ids.dim() == 1
        if squeeze:
            i_ids = i_ids[:, None]
        pos_ids = pos_cols[0].get_feature_data(batch) if self.use_pos else None
        neg_ids = neg_cols[0].get_feature_data(batch) if self.use_neg else None
        rows = batch.get(rows_key)
        states = [ids for ids in (pos_ids, neg_ids) if ids is not None]
        if rows is not None:  # one injected block, cut in _gather_ids order
            i_vectors, *state_vectors = _split_rows(rows, self.emb_size, i_ids.shape,
                                                    *(s.shape for s in states))
        else:
            i_vectors = self._item_vec(i_ids)  # [B, N, E]
            state_vectors = [self._item_vec(s) for s in states]
        b, n = i_vectors.shape[:2]
        branches = []
        if self.use_long:
            u_ids = self.uid_column.get_feature_data(batch)  # [B]
            u_rows = batch.get(u_rows_key)
            u_vec = (u_rows.reshape(*u_ids.shape, self.emb_size) if u_rows is not None
                     else self.u_embeddings(u_ids))
            u_vectors = u_vec[:, None, :].expand(i_vectors.shape)
            branches.append(self.long_mlp(torch.cat([u_vectors, i_vectors], dim=-1),
                                          train=train, generator=generator))
        for active, cols, rnn, mlp in ((self.use_pos, pos_cols, "pos_rnn", "pos_mlp"),
                                       (self.use_neg, neg_cols, "neg_rnn", "neg_mlp")):
            if not active:
                continue
            hidden = getattr(self, rnn)(state_vectors.pop(0), cols[1].get_feature_data(batch))
            hidden = hidden[:, None, :].expand(b, n, hidden.shape[-1])
            branches.append(getattr(self, mlp)(torch.cat([hidden, i_vectors], dim=-1),
                                               train=train, generator=generator))
        fused = self.fuse(torch.cat(branches, dim=-1), train=train, generator=generator)
        prediction = self.prediction(fused)[..., 0]  # [B, N]
        return prediction[:, 0] if squeeze else prediction

    def q_values(self, batch: Batch, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._score(batch, self.iid_column.get_feature_data(batch), self.pos_cols,
                           self.neg_cols, train, generator, self.I_ROWS_KEY, self.U_ROWS_KEY)

    def next_forward(self, batch: Batch) -> torch.Tensor:
        return self._score(batch, self.rl_sample_column.get_feature_data(batch),
                           self.pos_next_cols, self.neg_next_cols, False, None,
                           self.N_I_ROWS_KEY, self.N_U_ROWS_KEY)

    def _gather_ids(self, batch: Batch, i_ids: torch.Tensor, pos_column,
                    neg_column) -> torch.Tensor:
        parts = [i_ids.reshape(-1)]
        if self.use_pos:
            parts.append(pos_column.get_feature_data(batch).reshape(-1))
        if self.use_neg:
            parts.append(neg_column.get_feature_data(batch).reshape(-1))
        return torch.cat(parts)

    def _forward_gather_ids(self, batch: Batch) -> torch.Tensor:
        return self._gather_ids(batch, self.iid_column.get_feature_data(batch),
                                self.pos_cols[0], self.neg_cols[0])

    def _next_gather_ids(self, batch: Batch) -> torch.Tensor:
        return self._gather_ids(batch, self.rl_sample_column.get_feature_data(batch),
                                self.pos_next_cols[0], self.neg_next_cols[0])

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        ids = {"i_embeddings/embedding": self._forward_gather_ids(batch)}
        if self.use_long:
            ids["u_embeddings/embedding"] = self.uid_column.get_feature_data(batch)
        return ids

    def _specs(self, item_ids: torch.Tensor, i_key: str, u_key: str,
               batch: Batch) -> Dict[str, dict]:
        specs = {"i": self._item_spec(item_ids, i_key)}
        if self.use_long:
            specs["u"] = sharded_spec("u_embeddings/embedding",
                                      self.uid_column.get_feature_data(batch), u_key)
        return specs

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        return self._specs(self._forward_gather_ids(batch), self.I_ROWS_KEY, self.U_ROWS_KEY,
                           batch)

    def sharded_target_specs(self, batch: Batch) -> Dict[str, dict]:
        """The target network's next-step gathers (the same uid rows)."""
        return self._specs(self._next_gather_ids(batch), self.N_I_ROWS_KEY, self.N_U_ROWS_KEY,
                           batch)


class ValueRLModel:
    """One Q-network, its target and the Bellman target (reference
    model/IValueRLModel.py:50-88 and model/DQN.py:96-101)."""

    def __init__(self, qnet: QNet, reward_column: CategoricalColumnWithIdentity,
                 gamma: float = 0.9, update_freq: int = 10):
        self.qnet = qnet
        self.reward_column = reward_column
        self.gamma = float(gamma)
        self.update_freq = int(update_freq)

    def make_target(self) -> QNet:
        """A copy of the network, its values as they are now, that takes no
        gradient and runs in eval mode. Each tensor is copied contiguous (a
        packed trainer's table is a strided view of its ``[V, W]`` rows;
        the copy holds its ``[V, E]`` values only)."""
        memo = {id(t): t.detach().clone(memory_format=torch.contiguous_format)
                for t in self.qnet.buffers()}
        memo.update({id(p): torch.nn.Parameter(p.detach().clone(
            memory_format=torch.contiguous_format), requires_grad=False)
            for p in self.qnet.parameters()})
        return copy.deepcopy(self.qnet, memo).eval()

    def apply(self, batch: Batch, target: QNet, train: bool = False,
              generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(main_q, target_q)``: the network's Q of the batch's actions and
        ``reward + gamma * max(target.next_forward(batch), -1)``, the latter
        under ``torch.no_grad()``."""
        main_q = self.qnet.q_values(batch, train=train, generator=generator)
        reward = self.reward_column.get_feature_data(batch).to(torch.float32)
        with torch.no_grad():
            next_q = target.next_forward(batch)
            target_q = reward + self.gamma * torch.amax(next_q, dim=-1)
        return main_q, target_q

    def apply_eval(self, batch: Batch) -> torch.Tensor:
        """Candidate scoring for dev/test ranking evaluation."""
        return self.qnet.q_values(batch, train=False)

    def sparse_table_ids(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return self.qnet.sparse_table_ids(batch)

    def sharded_table_specs(self, batch: Batch) -> Dict[str, dict]:
        return self.qnet.sharded_table_specs(batch)

    def sharded_target_specs(self, batch: Batch) -> Dict[str, dict]:
        return self.qnet.sharded_target_specs(batch)

    @staticmethod
    def load_pretrain_embedding(qnet: QNet, weight_file: str,
                                source_path: str = "i_embeddings/embedding",
                                target_path: str = "i_embedding/embedding") -> QNet:
        """Warm-start a network's item table, in place, from a weights file
        of the port (``Trainer.save_weights``: the leaves by flax path, e.g.
        a FunkSVD run's). The shapes must match. Returns ``qnet``. After
        ``init_state`` load it into ``trainer.model`` and
        ``trainer.state.target`` both."""
        source = torch.load(weight_file, map_location="cpu", weights_only=True)
        if source_path not in source:
            raise KeyError(f"{source_path!r} not in {sorted(source)}")
        table = source[source_path]
        own = qnet.get_parameter(target_path.replace("/", "."))
        if tuple(own.shape) != tuple(table.shape):
            raise ValueError(f"{target_path!r} is {tuple(own.shape)}, {source_path!r} is "
                             f"{tuple(table.shape)}")
        with torch.no_grad():
            own.copy_(table)
        return qnet


def make_deers_qnet(**kwargs) -> BranchQNet:
    return BranchQNet(use_long=False, use_pos=True, use_neg=True, **kwargs)


def make_lsrl_qnet(**kwargs) -> BranchQNet:
    return BranchQNet(use_long=True, use_pos=True, use_neg=True, **kwargs)


def make_lsrl_l_qnet(**kwargs) -> BranchQNet:
    return BranchQNet(use_long=True, use_pos=False, use_neg=False, **kwargs)


def make_lsrl_ps_qnet(**kwargs) -> BranchQNet:
    return BranchQNet(use_long=False, use_pos=True, use_neg=False, **kwargs)


def make_lsrl_lps_qnet(**kwargs) -> BranchQNet:
    return BranchQNet(use_long=True, use_pos=True, use_neg=False, **kwargs)


def make_lsrl_psns_qnet(**kwargs) -> BranchQNet:
    return BranchQNet(use_long=False, use_pos=True, use_neg=True, **kwargs)
