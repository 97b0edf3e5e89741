"""Ranking and CTR metrics (port of ``pytorchrec_tpu/metric/metrics.py``).

A metric takes the predictions of a whole split on the host, as numpy:
``MetricList(metrics, user_sample_n)(prediction, target) -> {name: float}``.
Rank metrics (``ndcg@k``, ``hit@k``) read ``[users, user_sample_n]`` candidate
rows whose column 0 is the positive; point-wise ones (``auc``, ``logloss``,
``mse``) read logits against labels; ``auc/1`` is a point-wise metric on
task column 1 of a multi-task ``[..., T]`` prediction.

With one positive a row, its rank is ``1 + #{j > 0 : score_j > score_0}``: an
O(N) comparison that reproduces a stable argsort's tie order exactly (the
positive, column 0, goes before any tied negative). The rank metrics average
in float32, as the JAX package does on its device; AUC ranks ties at their
mean rank in float64.

The streaming partials fold one eval batch at a time into a fixed-size
accumulator on the prediction's device (``partial_init``, ``partial_update``,
``partial_finalize``), so evaluation memory does not grow with the split: a
histogram of the positive's rank (exact for NDCG and Hit), running sums
(exact for logloss and MSE), and positive and negative histograms over
``AUC_BINS`` sigmoid bins with within-bin ties counted half (AUC to about
1e-4). ``partial_update`` is eager torch on the device: ``index_add_`` for
the histograms, ``F.logsigmoid`` for the logloss.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

Accumulator = Dict[str, torch.Tensor]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pos_rank_from_scores(prediction, user_sample_n: int) -> np.ndarray:
    """``[rows]`` or ``[users, user_sample_n]`` scores -> the 1-based rank of
    column 0 in each row."""
    scores = _host(prediction).reshape(-1, user_sample_n)
    return 1 + np.sum(scores[:, 1:] > scores[:, :1], axis=1)


class Metric:
    """Base metric. ``fast_calc`` reads precomputed positive ranks."""

    name = "metric"

    def __init__(self, user_sample_n: int):
        self.user_sample_n = int(user_sample_n)

    def fast_calc(self, pos_ranks):
        raise NotImplementedError

    def __call__(self, prediction, target=None):
        return float(self.fast_calc(pos_rank_from_scores(prediction, self.user_sample_n)))


class NDCG(Metric):
    """NDCG@k with the positive first in each candidate row."""

    def __init__(self, user_sample_n: int, k: int):
        super().__init__(user_sample_n)
        self.k = int(k)
        self.name = f"ndcg@{self.k}"

    def fast_calc(self, pos_ranks):
        ranks = np.asarray(pos_ranks)
        gains = np.where(ranks <= self.k, 1.0 / np.log2(ranks.astype(np.float32) + 1.0), 0.0)
        return np.mean(gains.astype(np.float32))


class Hit(Metric):
    """Hit@k: the share of rows whose positive ranks within k."""

    def __init__(self, user_sample_n: int, k: int):
        super().__init__(user_sample_n)
        self.k = int(k)
        self.name = f"hit@{self.k}"

    def fast_calc(self, pos_ranks):
        return np.mean((np.asarray(pos_ranks) <= self.k).astype(np.float32))


class AUC(Metric):
    """Point-wise ROC-AUC of ``(prediction, target)`` pairs, ties at their
    mean rank."""

    name = "auc"

    def __init__(self, user_sample_n: int = 1):
        super().__init__(user_sample_n)

    def fast_calc(self, pos_ranks):  # pragma: no cover - not rank based
        raise NotImplementedError("AUC is computed from (prediction, target)")

    def __call__(self, prediction, target):
        scores = _host(prediction).reshape(-1)
        labels = _host(target).reshape(-1)
        n = len(scores)
        order = np.argsort(scores, kind="mergesort")
        sorted_scores = scores[order]
        # each element's rank is the mean 1-based rank of its group of ties
        boundaries = np.empty(n, dtype=bool)
        boundaries[0] = True
        boundaries[1:] = sorted_scores[1:] != sorted_scores[:-1]
        group_ids = np.cumsum(boundaries) - 1
        group_starts = np.flatnonzero(boundaries)
        group_ends = np.append(group_starts[1:], n)  # exclusive
        mean_rank = 0.5 * (group_starts + group_ends - 1) + 1.0
        ranks = mean_rank[group_ids]
        pos_mask = labels[order] > 0.5
        n_pos = int(pos_mask.sum())
        n_neg = n - n_pos
        if n_pos == 0 or n_neg == 0:
            return 0.5
        return float((ranks[pos_mask].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _log_sigmoid(x: np.ndarray) -> np.ndarray:
    return -np.logaddexp(0.0, -x)


class LogLoss(Metric):
    """Point-wise binary logloss of logits, in float64."""

    name = "logloss"

    def __init__(self, user_sample_n: int = 1):
        super().__init__(user_sample_n)

    def fast_calc(self, pos_ranks):  # pragma: no cover - not rank based
        raise NotImplementedError("LogLoss is computed from (prediction, target)")

    def __call__(self, prediction, target):
        logits = _host(prediction).reshape(-1).astype(np.float64)
        labels = _host(target).reshape(-1).astype(np.float64)
        loss = -(labels * _log_sigmoid(logits) + (1 - labels) * _log_sigmoid(-logits))
        return float(np.mean(loss))


class MSE(Metric):
    """Point-wise mean squared error of raw predictions, in float64."""

    name = "mse"

    def __init__(self, user_sample_n: int = 1):
        super().__init__(user_sample_n)

    def fast_calc(self, pos_ranks):  # pragma: no cover - not rank based
        raise NotImplementedError("MSE is computed from (prediction, target)")

    def __call__(self, prediction, target):
        pred = _host(prediction).reshape(-1).astype(np.float64)
        labels = _host(target).reshape(-1).astype(np.float64)
        return float(np.mean(np.square(pred - labels)))


RANK_METRICS = {"ndcg": NDCG, "hit": Hit}
POINTWISE_METRICS = {"auc": AUC, "logloss": LogLoss, "mse": MSE}


class TaskSlice(Metric):
    """A point-wise metric on one task column of multi-task ``[..., T]``
    predictions and targets: ``auc/0`` is the AUC of task 0's column."""

    def __init__(self, inner: Metric, task: int):
        super().__init__(inner.user_sample_n)
        self.inner = inner
        self.task = int(task)
        self.name = f"{inner.name}/{self.task}"

    def fast_calc(self, pos_ranks):  # pragma: no cover - not rank based
        raise NotImplementedError(f"{self.name} is pointwise")

    def __call__(self, prediction, target):
        p, t = _host(prediction), _host(target)
        assert p.ndim >= 2, f"{self.name} needs multi-task [..., T] predictions, got {p.shape}"
        return self.inner(p[..., self.task], t[..., self.task])


def _is_pointwise(metric: Metric) -> bool:
    return type(metric) in POINTWISE_METRICS.values() or isinstance(metric, TaskSlice)


def get_metric(metric_name: str, user_sample_n: int = 100) -> Metric:
    """Parse ``"ndcg@10"``, ``"hit@5"``, ``"auc"``, ``"logloss"``, ``"mse"``
    or ``"auc/1"`` (a point-wise metric on one task column). ``user_sample_n``
    is the width of a candidate row (the positive and its negatives)."""
    name = metric_name.strip().lower()
    if "/" in name:
        base, task = name.split("/")
        if base not in POINTWISE_METRICS:
            raise ValueError(f"unknown metric {metric_name!r} (task slices apply to pointwise "
                             f"metrics: {sorted(POINTWISE_METRICS)})")
        return TaskSlice(POINTWISE_METRICS[base](user_sample_n), int(task))
    if "@" in name:
        cls_name, k = name.split("@")
        if cls_name not in RANK_METRICS:
            raise ValueError(f"unknown metric {metric_name!r}")
        return RANK_METRICS[cls_name](user_sample_n, int(k))
    if name in POINTWISE_METRICS:
        return POINTWISE_METRICS[name](user_sample_n)
    raise ValueError(f"unknown metric {metric_name!r}")


def _auc_from_histograms(pos: np.ndarray, neg: np.ndarray) -> float:
    """AUC from per-bin positive and negative counts, in float64: each
    positive beats the negatives of the bins below and half of its own."""
    pos, neg = pos.astype(np.float64), neg.astype(np.float64)
    n_pos, n_neg = pos.sum(), neg.sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    cum_neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
    return float((pos * (cum_neg_below + 0.5 * neg)).sum() / (n_pos * n_neg))


def _logloss_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits))


class MetricList:
    """Every metric of an evaluation: the positive ranks are computed once
    for all rank metrics, the point-wise metrics each on their own."""

    AUC_BINS = 16384

    def __init__(self, metrics: Sequence[Union[Metric, str]], user_sample_n: int = 100):
        self.metrics: List[Metric] = [
            get_metric(m, user_sample_n) if isinstance(m, str) else m for m in metrics]
        # a plain point-wise metric beside task-sliced ones would pool every
        # task column of a multi-task [B, T] prediction into one number; that
        # is only known once a prediction comes, so the guard runs at call time
        self._plain_with_slices: List[str] = []
        if any(isinstance(m, TaskSlice) for m in self.metrics):
            self._plain_with_slices = [m.name for m in self.metrics
                                       if _is_pointwise(m) and not isinstance(m, TaskSlice)]
        rank_metrics = [m for m in self.metrics if type(m) in RANK_METRICS.values()]
        if rank_metrics:
            self.user_sample_n = rank_metrics[0].user_sample_n
            for metric in rank_metrics:
                assert metric.user_sample_n == self.user_sample_n, (
                    "all rank metrics must share user_sample_n")
        else:
            self.user_sample_n = user_sample_n

    def _check_slice_mixing(self, prediction) -> None:
        if self._plain_with_slices and getattr(prediction, "ndim", 1) >= 2 \
                and prediction.shape[-1] > 1:
            raise AssertionError(
                f"plain pointwise metrics {self._plain_with_slices} cannot be combined with "
                "task-sliced metrics on multi-task [B, T] predictions; use their sliced forms "
                "(e.g. 'auc/0')")

    def __call__(self, prediction, target=None) -> Dict[str, float]:
        prediction = _host(prediction)
        target = None if target is None else _host(target)
        self._check_slice_mixing(prediction)
        logs: Dict[str, float] = {}
        pos_ranks = None
        for metric in self.metrics:
            if _is_pointwise(metric):
                logs[metric.name] = float(metric(prediction, target))
            else:
                if pos_ranks is None:
                    pos_ranks = pos_rank_from_scores(prediction, self.user_sample_n)
                logs[metric.name] = float(metric.fast_calc(pos_ranks))
        return logs

    # ------------------------------------------------------------------
    # streaming partials
    # ------------------------------------------------------------------

    def _has(self, *classes) -> bool:
        return any(type(m) in classes for m in self.metrics)

    def partial_init(self, device=None) -> Accumulator:
        """The zeroed accumulator (float32 tensors on ``device``)."""
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        state: Accumulator = {}
        if self._has(*RANK_METRICS.values()):
            state["rank_hist"] = zeros(self.user_sample_n)
        if self._has(AUC):
            state["auc_pos"] = zeros(self.AUC_BINS)
            state["auc_neg"] = zeros(self.AUC_BINS)
        if self._has(LogLoss):
            state["logloss_sum"] = zeros()
        if self._has(MSE):
            state["mse_sum"] = zeros()
        if self._has(LogLoss, MSE):
            state["n_points"] = zeros()
        for m in self.metrics:  # task-sliced metrics: their own sums by name
            if isinstance(m, TaskSlice):
                if isinstance(m.inner, AUC):
                    state[f"{m.name}|pos"] = zeros(self.AUC_BINS)
                    state[f"{m.name}|neg"] = zeros(self.AUC_BINS)
                else:
                    state[f"{m.name}|sum"] = zeros()
                state["slice_rows"] = zeros()
        return state

    def _add_auc(self, pos: torch.Tensor, neg: torch.Tensor, logits: torch.Tensor,
                 labels: torch.Tensor, ok: torch.Tensor) -> None:
        bins = (torch.sigmoid(logits) * self.AUC_BINS).to(torch.int32).clamp_(0, self.AUC_BINS - 1)
        is_pos = (labels > 0.5).to(torch.float32)
        pos.index_add_(0, bins, ok * is_pos)
        neg.index_add_(0, bins, ok * (1.0 - is_pos))

    def partial_update(self, state: Accumulator, prediction: torch.Tensor, target,
                       valid: int) -> Accumulator:
        """Fold one eval batch into ``state`` (in place; returned). ``valid``
        counts the batch's real leading rows (a last batch is padded,
        ``data/loader.py``); the padded rows add nothing."""
        self._check_slice_mixing(prediction)
        device = prediction.device
        lead = prediction.shape[0]
        row_ok = (torch.arange(lead, device=device) < valid).to(torch.float32)
        if "rank_hist" in state:
            scores = prediction.reshape(-1, self.user_sample_n)
            ranks = 1 + (scores[:, 1:] > scores[:, :1]).sum(dim=1)
            rows_ok = torch.arange(scores.shape[0], device=device) < valid
            # a padded row adds 0 at rank 1 (JAX drops it out of range)
            state["rank_hist"].index_add_(0, torch.where(rows_ok, ranks - 1, 0),
                                          rows_ok.to(torch.float32))
        if {"auc_pos", "logloss_sum", "mse_sum"} & state.keys():
            # valid counts leading rows; a [rows, candidates] prediction
            # masks whole rows
            ok = row_ok.reshape((lead,) + (1,) * (prediction.dim() - 1)).expand(
                prediction.shape).reshape(-1)
            logits = prediction.reshape(-1)
            labels = torch.as_tensor(target, device=device).reshape(-1).to(logits.dtype)
            if "auc_pos" in state:
                self._add_auc(state["auc_pos"], state["auc_neg"], logits, labels, ok)
            if "logloss_sum" in state:
                state["logloss_sum"] += (ok * _logloss_terms(logits, labels)).sum()
            if "mse_sum" in state:
                state["mse_sum"] += (ok * (logits - labels).square()).sum()
            if "n_points" in state:
                state["n_points"] += ok.sum()
        slices = [m for m in self.metrics if isinstance(m, TaskSlice)]
        if slices:
            labels_full = torch.as_tensor(target, device=device).to(prediction.dtype)
            for m in slices:
                logits, labels = prediction[..., m.task], labels_full[..., m.task]
                if isinstance(m.inner, AUC):
                    self._add_auc(state[f"{m.name}|pos"], state[f"{m.name}|neg"], logits,
                                  labels, row_ok)
                elif isinstance(m.inner, LogLoss):
                    state[f"{m.name}|sum"] += (row_ok * _logloss_terms(logits, labels)).sum()
                else:  # MSE
                    state[f"{m.name}|sum"] += (row_ok * (logits - labels).square()).sum()
            state["slice_rows"] += row_ok.sum()
        return state

    def partial_finalize(self, state: Accumulator) -> Dict[str, float]:
        """The metrics from the accumulator, on the host in float64."""
        state = {k: _host(v) for k, v in state.items()}
        logs: Dict[str, float] = {}
        for metric in self.metrics:
            if isinstance(metric, (NDCG, Hit)):
                hist = state["rank_hist"]
                total = hist.sum()
                ranks = np.arange(1, self.user_sample_n + 1)
                if isinstance(metric, NDCG):
                    gains = np.where(ranks <= metric.k, 1.0 / np.log2(ranks + 1.0), 0.0)
                else:
                    gains = (ranks <= metric.k).astype(np.float64)
                logs[metric.name] = float((hist * gains).sum() / max(total, 1.0))
            elif isinstance(metric, AUC):
                logs[metric.name] = _auc_from_histograms(state["auc_pos"], state["auc_neg"])
            elif isinstance(metric, TaskSlice):
                if isinstance(metric.inner, AUC):
                    logs[metric.name] = _auc_from_histograms(state[f"{metric.name}|pos"],
                                                             state[f"{metric.name}|neg"])
                else:
                    logs[metric.name] = float(state[f"{metric.name}|sum"]
                                              / max(state["slice_rows"], 1.0))
            elif isinstance(metric, LogLoss):
                logs[metric.name] = float(state["logloss_sum"] / max(state["n_points"], 1.0))
            elif isinstance(metric, MSE):
                logs[metric.name] = float(state["mse_sum"] / max(state["n_points"], 1.0))
        return logs


__all__ = ["AUC", "Accumulator", "Hit", "LogLoss", "MSE", "Metric", "MetricList", "NDCG",
           "POINTWISE_METRICS", "RANK_METRICS", "TaskSlice", "get_metric",
           "pos_rank_from_scores"]
