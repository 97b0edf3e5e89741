"""Dense optimizers (port of ``pytorchrec_tpu/optim/optimizers.py``): sgd and
adam, over the parameters they are given.

* ``adam`` is ``torch.optim.Adam``. Its update is optax.adam's,
  ``lr * m_hat / (sqrt(v_hat) + eps)`` with bias-corrected moments (PyTorch
  folds the corrections into the step size and the denominator, which agrees
  to f32 rounding), and its ``weight_decay`` adds ``wd * param`` to the
  gradient before the moments: the coupled L2 of
  ``optax.add_decayed_weights`` placed before ``optax.adam``.
* ``sgd`` is ``torch.optim.SGD`` without momentum: ``param -= lr * g``, with
  the same coupled L2.

On the card both take PyTorch's fused single-kernel update, on the CPU the
single-tensor loop: ``fused`` and ``foreach`` are set explicitly, never left
to PyTorch's defaults. On the card ``adam`` is also ``capturable``: its step
count lives on the device, so one optimizer serves the eager step and the
CUDA graphs of ``Trainer.fit_steps`` (the fused update computes the same
values either way). ``sgd`` has no step count and no such flag: its fused
update is captured as it is.

``adamw`` and ``adagrad`` come with the optimizer registry (A9) and raise
until then. Their hazards: optax.adagrad starts its accumulator at 0.1 and
puts eps inside the square root; the JAX adamw is a decoupled-decay chain
with a bias mask, not ``torch.optim.AdamW``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch


def _fused(params: list) -> bool:
    return bool(params) and all(p.device.type == "cuda" for p in params)


def _groups(params: list) -> list:
    """``params``, or one empty group where there is no dense parameter (a
    model whose every table is packed, as FunkSVD under the sparse trainer):
    its steps then do nothing, as optax's over an empty tree."""
    return params or [{"params": []}]


def _sgd(params: list, lr: float, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    return torch.optim.SGD(_groups(params), lr=lr, momentum=0.0, weight_decay=weight_decay,
                           foreach=False, fused=_fused(params))


def _adam(params: list, lr: float, weight_decay: float = 0.0, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Optimizer:
    fused = _fused(params)
    # capturable also where there is no parameter: a CUDA graph may capture
    # the step of an empty group, which torch allows only so
    optimizer = torch.optim.Adam(_groups(params), lr=lr, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay, foreach=False, fused=fused,
                                 capturable=fused or not params)
    # eager steps on the card are meant: no warning that they run uncaptured
    optimizer._warned_capturable_if_run_uncaptured = True
    return optimizer


OPTIMIZERS: Dict[str, Callable[..., torch.optim.Optimizer]] = {"sgd": _sgd, "adam": _adam}


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter], lr: float,
                    weight_decay: float = 0.0, **kwargs) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params`` (the dense parameters)."""
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet; ported: "
                                  f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](list(params), lr=lr, weight_decay=weight_decay, **kwargs)
