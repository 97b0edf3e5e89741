"""Dataset generators and raw-data formatters (port of
``pytorchrec_tpu/data/process/datasets``), writing numpy frames:

* the synthetic generators: ``generate_synthetic_ml``,
  ``generate_synthetic_ctr``;
* the raw formatters: MovieLens 100K/1M/10M, Amazon, Jester, XING
  (``raw.py``: their tables without pandas) and Criteo (``.npz`` shards for
  the streaming source).

``__all__`` names the generators only (``tests/test_torch_package.py`` pins
it); the formatters are imported here, as in the JAX package, and are
reached by name.
"""

from pytorchrec_tpu_torch.data.process.datasets.synthetic import (
    generate_synthetic_ctr,
    generate_synthetic_ml,
)
from pytorchrec_tpu_torch.data.process.datasets.movielens import (
    format_movielens_100k,
    format_movielens_1m,
    format_movielens_10m,
)
from pytorchrec_tpu_torch.data.process.datasets.amazon import (
    format_amazon,
    format_amazon_beauty,
    format_amazon_cellphones,
    format_amazon_grocery,
)
from pytorchrec_tpu_torch.data.process.datasets.jester import format_jester
from pytorchrec_tpu_torch.data.process.datasets.xing import (
    format_xing,
    prepare_interaction_data,
    prepare_item_data,
    prepare_user_data,
)
from pytorchrec_tpu_torch.data.process.datasets.criteo import format_criteo

__all__ = ["generate_synthetic_ml", "generate_synthetic_ctr"]
