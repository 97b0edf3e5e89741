"""Dataset generators (port of ``pytorchrec_tpu/data/process/datasets``):
the synthetic ones, which write numpy frames. The raw formatters come with
the next part of the data layer."""

from pytorchrec_tpu_torch.data.process.datasets.synthetic import (
    generate_synthetic_ctr,
    generate_synthetic_ml,
)

__all__ = ["generate_synthetic_ml", "generate_synthetic_ctr"]
