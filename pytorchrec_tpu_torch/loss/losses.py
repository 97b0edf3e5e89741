"""Loss functions (port of ``pytorchrec_tpu/loss/losses.py``): BCE, MSE,
BPR and the sampled-softmax cross entropy.

Each takes ``(prediction, target)`` and a reduction (``mean``, ``sum`` or
``none``). The other ranking and multi-task losses (top1, esmm) come with
the task slices.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _reduce(values: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return values.mean()
    if reduction == "sum":
        return values.sum()
    if reduction == "none":
        return values
    raise ValueError(f"unknown reduction {reduction!r}")


def mse_loss(prediction: torch.Tensor, target: torch.Tensor,
             reduction: str = "mean") -> torch.Tensor:
    return _reduce(torch.square(prediction - target), reduction)


def bce_loss(prediction: torch.Tensor, target: torch.Tensor,
             reduction: str = "mean") -> torch.Tensor:
    """Binary cross entropy on logits, in the stable log-sigmoid form
    ``-(t * logsigmoid(p) + (1 - t) * logsigmoid(-p))``."""
    return _reduce(-(target * F.logsigmoid(prediction)
                     + (1.0 - target) * F.logsigmoid(-prediction)), reduction)


def bpr_loss(prediction: torch.Tensor, target=None, reduction: str = "mean") -> torch.Tensor:
    """Pairwise BPR on ``[B, 2]`` (positive, negative) scores:
    ``softplus(neg - pos)``. ``target`` is ignored: the pair layout is
    positional."""
    if prediction.dim() != 2 or prediction.shape[1] != 2:
        raise ValueError(f"bpr_loss takes [B, 2] scores, got {tuple(prediction.shape)}")
    return _reduce(F.softplus(prediction[:, 1] - prediction[:, 0]), reduction)


def softmax_ce_loss(prediction: torch.Tensor, target=None, reduction: str = "mean") -> torch.Tensor:
    """Sampled-softmax cross entropy on ``[B, N >= 2]`` positive-first logits:
    ``-log_softmax(prediction)[:, 0]``; with TwoTower's in-batch layout, the
    in-batch-negatives loss. ``target`` is ignored: the layout is
    positional."""
    if prediction.dim() != 2 or prediction.shape[1] < 2:
        raise ValueError(f"softmax_ce_loss takes [B, N >= 2] logits, got {tuple(prediction.shape)}")
    return _reduce(-torch.log_softmax(prediction, dim=-1)[:, 0], reduction)


LOSSES = {"bce": bce_loss, "bpr": bpr_loss, "mse": mse_loss, "softmax": softmax_ce_loss}


def get_loss(loss_name: str) -> Callable:
    if loss_name not in LOSSES:
        raise NotImplementedError(f"loss {loss_name!r} is not ported yet; ported: {sorted(LOSSES)}")
    return LOSSES[loss_name]
