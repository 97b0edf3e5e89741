"""Loss functions (port of ``pytorchrec_tpu/loss/losses.py``): BCE, MSE,
BPR, TOP1, the sampled-softmax cross entropy and ESMM's entire-space loss,
and their registry ``LOSSES`` (``loss_name_list``, ``get_loss``), with the
JAX package's names.

Each takes ``(prediction, target)`` and a reduction (``mean``, ``sum`` or
``none``). ``bce`` also covers plain multi-task ``[B, T]`` logits (the
elementwise mean is the equal-weighted sum of the per-task BCEs).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from pytorchrec_tpu_torch.utils.registry import Registry


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


def top1_loss(prediction: torch.Tensor, target=None, reduction: str = "mean") -> torch.Tensor:
    """TOP1 on ``[B, 2]`` (positive, negative) scores:
    ``sigmoid(neg - pos) + sigmoid(neg^2)``. ``target`` is ignored."""
    if prediction.dim() != 2 or prediction.shape[1] != 2:
        raise ValueError(f"top1_loss takes [B, 2] scores, got {tuple(prediction.shape)}")
    pos, neg = prediction[:, 0], prediction[:, 1]
    return _reduce(torch.sigmoid(neg - pos) + torch.sigmoid(neg * neg), reduction)


def esmm_loss(prediction: torch.Tensor, target: torch.Tensor,
              reduction: str = "mean") -> torch.Tensor:
    """ESMM's entire-space loss on ``models/multitask.py::ESMM``'s ``[B, 2]``
    = (ctr logit, log pCTCVR) against the targets (click, click *
    conversion): ``bce(ctr_logit, click)`` plus the cross entropy of pCTCVR
    against ctcvr, both over every impression. The second probability comes
    as a log (a sum of log-sigmoids), clamped to at most -1e-7 so that
    ``log(1 - p) = log(-expm1(log p))`` stays finite."""
    if prediction.dim() != 2 or prediction.shape[1] != 2:
        raise ValueError(f"esmm_loss takes [B, 2] predictions, got {tuple(prediction.shape)}")
    ctr_logit, log_p = prediction[:, 0], prediction[:, 1]
    click, ctcvr = target[:, 0], target[:, 1]
    ctr_term = -(click * F.logsigmoid(ctr_logit) + (1.0 - click) * F.logsigmoid(-ctr_logit))
    # minimum, not clamp: at a tie its gradient is split, as jnp.minimum's
    log_p = torch.minimum(log_p, torch.full_like(log_p, -1e-7))
    log_not_p = torch.log(-torch.expm1(log_p))
    ctcvr_term = -(ctcvr * log_p + (1.0 - ctcvr) * log_not_p)
    return _reduce(ctr_term + ctcvr_term, reduction)


LOSSES: Registry[Callable] = Registry("loss")
LOSSES.register("bpr", bpr_loss)
LOSSES.register("top1", top1_loss)
LOSSES.register("mse", mse_loss)
LOSSES.register("bce", bce_loss)
LOSSES.register("softmax", softmax_ce_loss)
LOSSES.register("esmm", esmm_loss)

loss_name_list = list(LOSSES.names())


def get_loss(loss_name: str) -> Callable:
    return LOSSES.get(loss_name)
