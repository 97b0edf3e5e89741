"""Multi-task CTR family (port of ``pytorchrec_tpu/models/multitask.py``):
SharedBottom, MMoE, PLE and ESMM.

* ``SharedBottom``: one shared MLP trunk (``bottom``), per-task towers.
* ``MMoE`` (Ma et al., KDD 2018): K expert MLPs in one ``ExpertBank``
  (``experts``), a per-task softmax gate (``gate_<t>``) mixes them.
* ``PLE`` (Tang et al., RecSys 2020): CGC levels (``cgc_<lv>``), each one
  bank of ``(T + 1) * experts_per_group`` experts, T task groups and a
  shared one; task gate ``gate_<lv>_t<t>`` mixes its own group and the
  shared one, the shared gate ``gate_<lv>_shared`` (inner levels) mixes all.
* ``ESMM`` (Ma et al., SIGIR 2018): CTR and CVR towers (``ctr_tower``,
  ``cvr_tower``, ``ctr_head``, ``cvr_head``); it emits ``(ctr logit, log
  pCTCVR)`` and takes ``click * conversion`` as target 1, so the ``esmm``
  loss supervises the conversion head over every impression. Column 1 is a
  log-probability (``log_prob_task_columns``): ``Trainer.compile`` rejects
  ``logloss/1`` and ``mse/1`` on it.

Every model sits on ``_CTRBase`` (``models/ctr.py``), so every table format
of the CTR family serves it: per-field and unified f32, packed f32 under
the sparse trainer, int8 packed and classic under the quantized trainer.
There is no linear term (``_uses_linear = False``). The data are point-wise
rows only; ``task_columns`` holds one binary label column a task, and the
forward returns ``(logits [B, T], targets [B, T])`` (targets None where the
batch has no labels, as when serving). Per-task metrics are the task slices
``auc/0``, ``auc/1`` (``metric/metrics.py::TaskSlice``).

The parameters keep their flax names (``utils/convert.py``). An expert
bank's parameters are stacked on the expert axis, ``w_<i> [K, D, H]`` and
``b_<i> [K, H]``, and each layer is one batched product over that axis
(``ops/precision.py::expert_product``, at the train step's matmul
precision), as the JAX model's one einsum a layer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pytorchrec_tpu_torch.models.base import Batch, Prediction, label_target
from pytorchrec_tpu_torch.models.ctr import _CTRBase, _gather_fields, _ZeroBiasLinear
from pytorchrec_tpu_torch.ops.embedding import INIT_STD, normal_init
from pytorchrec_tpu_torch.ops.mlp import MLP, dropout, linear
from pytorchrec_tpu_torch.ops.precision import expert_product
from pytorchrec_tpu_torch.utils.device import resolve_device


class ExpertBank(nn.Module):
    """K expert MLPs evaluated together: ``[..., D] -> [..., K, H]``, or
    with ``per_expert=True`` ``[..., K, D] -> [..., K, H]`` (expert k reads
    its own row: PLE's group selectors). Each layer is ``relu(h @ w_i[k] +
    b_i[k])`` for every k in one batched product; ``w_<i>`` start normal(0,
    0.01) and ``b_<i>`` zero, as flax's."""

    def __init__(self, n_experts: int, in_features: int, layers: Sequence[int],
                 dropout: float = 0.0, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_experts, self.dropout = n_experts, dropout
        self.n_layers = len(layers)
        for i, width in enumerate(layers):
            self.register_parameter(f"w_{i}", nn.Parameter(
                normal_init((n_experts, in_features, width), device, generator)))
            self.register_parameter(f"b_{i}", nn.Parameter(
                torch.zeros((n_experts, width), dtype=torch.float32, device=device)))
            in_features = width
        self.out_features = in_features

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.n_layers):
            getattr(self, f"w_{i}").normal_(0.0, INIT_STD, generator=generator)
            getattr(self, f"b_{i}").zero_()

    def forward(self, x: torch.Tensor, train: bool = False, per_expert: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if per_expert:
            if x.shape[-2] != self.n_experts:
                raise ValueError(f"per_expert input needs {self.n_experts} rows, got "
                                 f"{tuple(x.shape)}")
            h = x
        else:
            h = x[..., None, :].expand(*x.shape[:-1], self.n_experts, x.shape[-1])
        for i in range(self.n_layers):
            h = torch.relu(expert_product(h, getattr(self, f"w_{i}")) + getattr(self, f"b_{i}"))
            if self.dropout > 0.0 and train:
                h = dropout(h, self.dropout, generator)
        return h


def _mix(gate: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """``[..., K]`` gate probabilities mix ``[..., K, H]`` experts into
    ``[..., H]``."""
    return torch.einsum("...k,...kh->...h", gate, experts)


class _MultiTaskBase(_CTRBase):
    """Shared plumbing: the field input vector, ``[B, T]`` targets and the
    task towers ``tower_<t>`` with their heads ``head_<t>``."""

    _uses_linear = False  # no wide/linear term in the multi-task family

    def __init__(self, *args, task_columns: Sequence = (), tower_layers: Sequence[int] = (64,),
                 dropout: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        device = resolve_device(device)
        super().__init__(*args, device=device, generator=generator, **kwargs)
        self.task_columns = tuple(task_columns)
        self.tower_layers = tuple(tower_layers)
        self.dropout = dropout
        if self.n_tasks < 1:
            raise ValueError(f"{type(self).__name__} needs at least one task column")
        self.input_dim = len(self.sparse_columns) * self.emb_size + len(self.dense_columns)

    @property
    def n_tasks(self) -> int:
        return len(self.task_columns)

    def _input_vector(self, batch: Batch) -> torch.Tensor:
        sparse, dense, candidate_mode = _gather_fields(batch, self.sparse_columns,
                                                       self.dense_columns)
        if candidate_mode:
            raise ValueError("multi-task models are point-wise (impression-log protocol)")
        parts = [self._embedded_concat(sparse, batch)]
        if dense:
            parts.append(torch.stack(dense, dim=-1))
        return torch.cat(parts, dim=-1)

    def _targets(self, batch: Batch) -> Optional[torch.Tensor]:
        columns = [label_target(c, batch) for c in self.task_columns]
        if any(c is None for c in columns):
            return None
        return torch.stack(columns, dim=-1)  # [B, T]

    def _make_towers(self, in_features: int, device, generator) -> None:
        self.towers = []
        for t in range(self.n_tasks):
            tower = MLP(in_features, self.tower_layers, activation="relu", dropout=self.dropout,
                        device=device, generator=generator)
            head = _ZeroBiasLinear(tower.out_features, 1, device, generator)
            self.add_module(f"tower_{t}", tower)
            self.add_module(f"head_{t}", head)
            self.towers.append((tower, head))

    def _tower_logits(self, per_task_inputs, train: bool,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        """``per_task_inputs[t] [..., H] -> logits [..., T]``."""
        return torch.stack([head(tower(x, train=train, generator=generator))[..., 0]
                            for (tower, head), x in zip(self.towers, per_task_inputs)], dim=-1)


class SharedBottom(_MultiTaskBase):
    """One shared trunk MLP, per-task towers: the multi-task baseline."""

    def __init__(self, *args, bottom_layers: Sequence[int] = (256, 128), device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        device = resolve_device(device)
        super().__init__(*args, device=device, generator=generator, **kwargs)
        self.bottom = MLP(self.input_dim, tuple(bottom_layers), activation="relu",
                          dropout=self.dropout, device=device, generator=generator)
        self._make_towers(self.bottom.out_features, device, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        h = self.bottom(self._input_vector(batch), train=train, generator=generator)
        return self._tower_logits([h] * self.n_tasks, train, generator), self._targets(batch)


class MMoE(_MultiTaskBase):
    """Multi-gate Mixture-of-Experts: ``f^t(x) = sum_k softmax(W_t x)_k *
    E_k(x)`` feeds task tower t."""

    def __init__(self, *args, n_experts: int = 4, expert_layers: Sequence[int] = (128, 64),
                 device=None, generator: Optional[torch.Generator] = None, **kwargs):
        device = resolve_device(device)
        super().__init__(*args, device=device, generator=generator, **kwargs)
        self.n_experts = n_experts
        self.experts = ExpertBank(n_experts, self.input_dim, tuple(expert_layers),
                                  dropout=self.dropout, device=device, generator=generator)
        self.gates = []
        for t in range(self.n_tasks):
            gate = linear(self.input_dim, n_experts, use_bias=False, device=device,
                          generator=generator)
            self.add_module(f"gate_{t}", gate)
            self.gates.append(gate)
        self._make_towers(self.experts.out_features, device, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        x = self._input_vector(batch)
        experts = self.experts(x, train=train, generator=generator)  # [B, K, H]
        per_task = [_mix(torch.softmax(gate(x), dim=-1), experts) for gate in self.gates]
        return self._tower_logits(per_task, train, generator), self._targets(batch)


class PLE(_MultiTaskBase):
    """Progressive Layered Extraction: ``n_levels`` CGC levels of T task
    expert groups and one shared group (``experts_per_group`` each, one
    bank a level); the last level feeds the task towers."""

    def __init__(self, *args, n_levels: int = 2, experts_per_group: int = 2,
                 expert_layers: Sequence[int] = (128, 64), device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        device = resolve_device(device)
        super().__init__(*args, device=device, generator=generator, **kwargs)
        if n_levels < 1:
            raise ValueError("PLE needs at least one level")
        self.n_levels, self.experts_per_group = n_levels, experts_per_group
        g, tasks = experts_per_group, self.n_tasks
        k_total = (tasks + 1) * g
        self.levels, self.task_gates, self.shared_gates = [], [], []
        width = self.input_dim
        for lv in range(n_levels):
            bank = ExpertBank(k_total, width, tuple(expert_layers), dropout=self.dropout,
                              device=device, generator=generator)
            self.add_module(f"cgc_{lv}", bank)
            self.levels.append(bank)
            gates = []
            for t in range(tasks):
                gate = linear(width, 2 * g, use_bias=False, device=device, generator=generator)
                self.add_module(f"gate_{lv}_t{t}", gate)
                gates.append(gate)
            self.task_gates.append(gates)
            if lv < n_levels - 1:
                gate = linear(width, k_total, use_bias=False, device=device, generator=generator)
                self.add_module(f"gate_{lv}_shared", gate)
                self.shared_gates.append(gate)
            width = bank.out_features
        self._make_towers(width, device, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        x = self._input_vector(batch)
        g, tasks = self.experts_per_group, self.n_tasks
        task_in, shared_in = [x] * tasks, x
        for lv, bank in enumerate(self.levels):
            # expert groups t*g:(t+1)*g read task t's selector, the last g the
            # shared one: the selectors repeated g times, one bank product
            selectors = torch.stack(task_in + [shared_in], dim=-2)  # [B, T+1, D]
            h = bank(torch.repeat_interleave(selectors, g, dim=-2), train=train,
                     per_expert=True, generator=generator)  # [B, K, H]
            shared = h[..., tasks * g:, :]
            new_task_in = []
            for t in range(tasks):
                candidates = torch.cat([h[..., t * g:(t + 1) * g, :], shared], dim=-2)
                gate = torch.softmax(self.task_gates[lv][t](task_in[t]), dim=-1)
                new_task_in.append(_mix(gate, candidates))
            if lv < self.n_levels - 1:
                shared_in = _mix(torch.softmax(self.shared_gates[lv](shared_in), dim=-1), h)
            task_in = new_task_in
        return self._tower_logits(task_in, train, generator), self._targets(batch)


class ESMM(_MultiTaskBase):
    """Entire-Space Multi-task Model: task 0 is CTR (click), task 1 CVR
    (conversion); ``[B, 2]`` = (ctr logit, ``log_sigmoid(ctr) +
    log_sigmoid(cvr)`` = log pCTCVR), against (click, click * conversion).
    Train with the ``esmm`` loss."""

    # prediction column 1 is log pCTCVR, a log-probability: Trainer.compile
    # rejects sigmoid-based slices (logloss/1, mse/1) on it
    log_prob_task_columns = (1,)

    def __init__(self, *args, bottom_layers: Sequence[int] = (256, 128), device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        device = resolve_device(device)
        super().__init__(*args, device=device, generator=generator, **kwargs)
        if self.n_tasks != 2:
            raise ValueError("ESMM is (click, conversion): two task columns")
        layers = tuple(bottom_layers)
        self.ctr_tower = MLP(self.input_dim, layers, activation="relu", dropout=self.dropout,
                             device=device, generator=generator)
        self.cvr_tower = MLP(self.input_dim, layers, activation="relu", dropout=self.dropout,
                             device=device, generator=generator)
        self.ctr_head = _ZeroBiasLinear(self.ctr_tower.out_features, 1, device, generator)
        self.cvr_head = _ZeroBiasLinear(self.cvr_tower.out_features, 1, device, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Prediction:
        x = self._input_vector(batch)
        ctr = self.ctr_head(self.ctr_tower(x, train=train, generator=generator))[..., 0]
        cvr = self.cvr_head(self.cvr_tower(x, train=train, generator=generator))[..., 0]
        prediction = torch.stack([ctr, nn.functional.logsigmoid(ctr)
                                  + nn.functional.logsigmoid(cvr)], dim=-1)
        t = self._targets(batch)  # [B, 2] = (click, conversion)
        if t is None:
            return prediction, None
        return prediction, torch.stack([t[..., 0], t[..., 0] * t[..., 1]], dim=-1)
