"""Dense optimizers (port of ``pytorchrec_tpu/optim/optimizers.py``): the
registry ``OPTIMIZERS`` (sgd, adam, adamw, adagrad) and ``build_optimizer``,
over the parameters they are given.

* ``adam`` is ``torch.optim.Adam``. Its update is optax.adam's,
  ``lr * m_hat / (sqrt(v_hat) + eps)`` with bias-corrected moments (PyTorch
  folds the corrections into the step size and the denominator, which agrees
  to f32 rounding), and its ``weight_decay`` adds ``wd * param`` to the
  gradient before the moments: the coupled L2 of
  ``optax.add_decayed_weights`` placed before ``optax.adam``.
* ``sgd`` is ``torch.optim.SGD`` without momentum: ``param -= lr * g``, with
  the same coupled L2.
* ``adamw`` is the JAX package's decoupled chain ``scale_by_adam(eps=1e-6)``,
  then ``+ wd * param`` where the parameter's flax path has no key that is
  exactly ``"bias"`` (``decays``: ``ExpertBank``'s ``b_<i>``, DIN's
  attention ``b<i>`` and the cross layers' ``bs`` are decayed, every
  ``Dense`` bias is not), then ``scale(-lr)``. ``torch.optim.AdamW`` over
  two parameter groups (the decayed ones and the rest, at weight decay 0)
  computes the same algebra in another order, ``param * (1 - lr * wd)``
  first; its eps is set to the chain's 1e-6.
* ``adagrad`` is ``optax.adagrad`` (``Adagrad`` below), not
  ``torch.optim.Adagrad``: the accumulator starts at 0.1 and eps (1e-10)
  sits inside the root, ``g * rsqrt(acc + eps)`` where ``acc > 0``; its
  ``weight_decay`` is the coupled L2 before it.

``build_optimizer(..., grad_clip_norm=c)`` puts ``optax.clip_by_global_norm``
in front: where the global norm ``n`` of the gradients reaches ``c``, each
becomes ``g / n * c`` (not ``torch.nn.utils.clip_grad_norm_``, which
divides by ``n + 1e-6`` and clamps). It is a step pre-hook of the optimizer
over the gradients of the parameters the optimizer holds, so under the
sparse and quantized trainers (whose optimizer holds the dense parameters
only, the port's form of ``optax.masked``) the norm covers the dense leaves
only. It runs on the device without a host sync.

On the card every update is capture-safe, so one optimizer serves the eager
step and the CUDA graphs of ``Trainer.fit_steps``: ``adam`` and ``adamw``
take PyTorch's fused single-kernel update with ``capturable`` (the step
count on the device), ``sgd`` its fused update, which has no step count;
``adagrad`` keeps its accumulators on the device from its construction and
steps without a host sync. On the CPU ``fused`` and ``foreach`` are off: the
single-tensor loop, set explicitly, never left to PyTorch's defaults.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence

import torch

from pytorchrec_tpu_torch.utils.registry import Registry

INITIAL_ACCUMULATOR = 0.1  # optax.adagrad's initial_accumulator_value


def _fused(params: list) -> bool:
    return bool(params) and all(p.device.type == "cuda" for p in params)


def _groups(params: list) -> list:
    """``params``, or one empty group where there is no dense parameter (a
    model whose every table is packed, as FunkSVD under the sparse trainer):
    its steps then do nothing, as optax's over an empty tree."""
    return params or [{"params": []}]


def decays(path: str) -> bool:
    """Whether adamw decays the parameter at flax path ``path``: unless one
    of its keys is exactly ``"bias"`` (the JAX package's
    ``default_weight_decay_mask``)."""
    return "bias" not in path.split("/")


def _sgd(params: list, lr: float, weight_decay: float = 0.0, **_) -> torch.optim.Optimizer:
    return torch.optim.SGD(_groups(params), lr=lr, momentum=0.0, weight_decay=weight_decay,
                           foreach=False, fused=_fused(params))


def _adam(params: list, lr: float, weight_decay: float = 0.0, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, **_) -> torch.optim.Optimizer:
    fused = _fused(params)
    # capturable also where there is no parameter: a CUDA graph may capture
    # the step of an empty group, which torch allows only so
    optimizer = torch.optim.Adam(_groups(params), lr=lr, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay, foreach=False, fused=fused,
                                 capturable=fused or not params)
    # eager steps on the card are meant: no warning that they run uncaptured
    optimizer._warned_capturable_if_run_uncaptured = True
    return optimizer


def _adamw(params: list, lr: float, weight_decay: float = 0.0, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-6, paths: Optional[Sequence[str]] = None,
           **_) -> torch.optim.Optimizer:
    fused = _fused(params)
    if weight_decay and params:
        if paths is None or len(paths) != len(params):
            raise ValueError("adamw's weight decay needs each parameter's flax path (paths=)")
        decayed = [p for p, path in zip(params, paths) if decays(path)]
        kept = [p for p, path in zip(params, paths) if not decays(path)]
        groups = [{"params": decayed, "weight_decay": weight_decay},
                  {"params": kept, "weight_decay": 0.0}]
    else:
        groups = _groups(params)
    optimizer = torch.optim.AdamW(groups, lr=lr, betas=(b1, b2), eps=eps,
                                  weight_decay=weight_decay, foreach=False, fused=fused,
                                  capturable=fused or not params)
    optimizer._warned_capturable_if_run_uncaptured = True
    return optimizer


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad`` (``scale_by_rss`` and ``scale_by_learning_rate``),
    with the coupled L2 of ``optax.add_decayed_weights`` before it:
    ``g += wd * p; acc += g * g; p += -lr * (g * where(acc > 0,
    rsqrt(acc + eps), 0))``. The accumulators (``state[p]["sum"]``) are made
    at construction, on each parameter's device, at optax's 0.1; a step
    reads nothing back to the host, so a CUDA graph captures it."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, eps: float = 1e-10):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum"] = torch.full_like(p, INITIAL_ACCUMULATOR,
                                                       memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + wd * p
                acc = self.state[p]["sum"]
                acc.add_(g * g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + eps), 0.0)
                p.add_((scale * g) * (-lr))
        return loss


def _adagrad(params: list, lr: float, weight_decay: float = 0.0, eps: float = 1e-10,
             **_) -> torch.optim.Optimizer:
    return Adagrad(_groups(params), lr=lr, weight_decay=weight_decay, eps=eps)


def clip_by_global_norm(params: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` on the gradients of ``params``, in
    place: with ``n = sqrt(sum of every g²)``, each ``g`` becomes
    ``g / n * max_norm`` where ``n >= max_norm``. No host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


OPTIMIZERS: Registry[Callable[..., torch.optim.Optimizer]] = Registry("optimizer")
OPTIMIZERS.register("sgd", _sgd)
OPTIMIZERS.register("adam", _adam)
OPTIMIZERS.register("adamw", _adamw)
OPTIMIZERS.register("adagrad", _adagrad)

optimizer_name_list = list(OPTIMIZERS.names())


def get_optimizer(name: str) -> Callable[..., torch.optim.Optimizer]:
    return OPTIMIZERS.get(name)


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter], lr: float,
                    weight_decay: float = 0.0, grad_clip_norm: Optional[float] = None,
                    paths: Optional[Sequence[str]] = None, **kwargs) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params`` (the dense parameters), their
    flax ``paths`` beside them (adamw's decay mask reads them), and with
    ``grad_clip_norm`` the global-norm clip before each step. ``kwargs``
    reach the optimizer (``b1``, ``b2``, ``eps``)."""
    params = list(params)
    optimizer = get_optimizer(name)(params, lr=lr, weight_decay=weight_decay,
                                    paths=None if paths is None else list(paths), **kwargs)
    if grad_clip_norm:
        max_norm = float(grad_clip_norm)
        optimizer.register_step_pre_hook(
            lambda opt, args, kwargs_: clip_by_global_norm(
                [p for group in opt.param_groups for p in group["params"]], max_norm))
    return optimizer
