"""The live environment, for logs and run records (port of
``pytorchrec_tpu/utils/version.py``): PyTorch's and CUDA's versions and the
cards this process sees.

The port is developed against torch 2.11 built for CUDA 12.8 on one NVIDIA
H100 (compute capability 9.0, the ``sm_90a`` kernels of ``csrc/``), and
tested on the CPU with torch built for it.
"""

from __future__ import annotations

from typing import Dict

import torch


def environment_summary() -> Dict[str, str]:
    """Versions and devices of the live environment."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = [torch.cuda.get_device_name(i) for i in range(count)]
    capabilities = ["%d.%d" % torch.cuda.get_device_capability(i) for i in range(count)]
    return {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "backend": "cuda" if count else "cpu",
        "devices": ",".join(names[:4]) + ("..." if count > 4 else ""),
        "compute_capability": ",".join(sorted(set(capabilities))),
        "n_devices": str(count),
    }
