"""Ranking and CTR metrics (port of ``pytorchrec_tpu/metric``)."""

from pytorchrec_tpu_torch.metric.metrics import (
    AUC,
    MSE,
    Hit,
    LogLoss,
    Metric,
    MetricList,
    NDCG,
    TaskSlice,
    get_metric,
    pos_rank_from_scores,
)

__all__ = ["AUC", "Hit", "LogLoss", "MSE", "Metric", "MetricList", "NDCG", "TaskSlice",
           "get_metric", "pos_rank_from_scores"]
