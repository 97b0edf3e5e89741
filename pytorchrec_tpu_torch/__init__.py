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
"""

__version__ = "0.1.0"
