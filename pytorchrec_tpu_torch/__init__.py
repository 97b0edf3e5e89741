"""pytorchrec_tpu_torch — the PyTorch/CUDA port of ``pytorchrec_tpu``.

Same sub-package layout and module names as the JAX package, so each module
has an obvious counterpart there; inside, PyTorch idiom (``nn.Module``s,
functions on tensors, an explicit ``device`` and ``torch.Generator``).

Every TPU (Pallas) kernel on a ported path is a CUDA C++ kernel for Hopper
(``csrc/``); each sits beside its plain PyTorch version, which runs only for
tensors that lie on the CPU (``ops/kernels/__init__.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (``utils/device.py``).

This package imports neither JAX nor any module of ``pytorchrec_tpu``.
The top-level names (``Task``, ``RepeatTask``, ``GridSearch``, the trainers,
``SplitMode``, ``TrainMode``) load on first use, as the JAX package's do.
"""

__version__ = "0.1.0"

# the top-level API, imported on first use
_LAZY = {
    "Trainer": ("pytorchrec_tpu_torch.training", "Trainer"),
    "RLTrainer": ("pytorchrec_tpu_torch.training", "RLTrainer"),
    "SparseEmbeddingTrainer": ("pytorchrec_tpu_torch.training", "SparseEmbeddingTrainer"),
    "QuantizedEmbeddingTrainer": ("pytorchrec_tpu_torch.training", "QuantizedEmbeddingTrainer"),
    "Task": ("pytorchrec_tpu_torch.tasks", "Task"),
    "RepeatTask": ("pytorchrec_tpu_torch.tasks", "RepeatTask"),
    "GridSearch": ("pytorchrec_tpu_torch.tasks", "GridSearch"),
    "SplitMode": ("pytorchrec_tpu_torch.data.schema", "SplitMode"),
    "TrainMode": ("pytorchrec_tpu_torch.data.schema", "TrainMode"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
