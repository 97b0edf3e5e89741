"""Trainer (port of ``pytorchrec_tpu/training/trainer.py``): the serving
surface for now.

``Trainer(model, device=None)`` places the model on the card (or on the CPU
when asked) and ``make_serving_fn()`` returns the scorer
``fn(batch) -> prediction``. The batch is a dict of numpy arrays or tensors;
it needs no label column. Compile, fit, evaluate and the sparse trainers
come with the training slices.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.utils.device import resolve_device

Batch = Dict[str, Any]


class Trainer:
    """Owns one model on one device."""

    def __init__(self, model: RecModel, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # everything runs in full f32, as the JAX reference does: no TF32
            # in matmuls (PyTorch's default) nor in cuDNN (not its default)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device)

    def make_serving_fn(self) -> Callable[[Batch], torch.Tensor]:
        """Scorer over the model's current parameters: moves the batch to the
        device and returns the prediction there (``[B]``, or ``[B, N]`` for
        candidate rows)."""
        model, device = self.model, self.device

        def serve(batch: Batch) -> torch.Tensor:
            tensors = {k: torch.as_tensor(v).to(device, non_blocking=True)
                       for k, v in batch.items()}
            with torch.inference_mode():
                prediction, _ = model(tensors, train=False)
            return prediction

        return serve
