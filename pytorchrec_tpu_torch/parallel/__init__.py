"""Multi-device training (port of ``pytorchrec_tpu/parallel``): the
``(data, model)`` mesh on ``torch.distributed`` (``mesh.py``), the
parameter sharding rules (``sharding.py``) and the sharded lookup
(``embedding_engine.py``)."""

from pytorchrec_tpu_torch.parallel.embedding_engine import masked_psum_lookup
from pytorchrec_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_sharding,
    initialize_distributed,
    make_mesh,
    replicated,
)
from pytorchrec_tpu_torch.parallel.sharding import (
    RowShard,
    is_embedding_table,
    param_shardings,
    shard_params,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "RowShard", "data_sharding",
           "initialize_distributed", "is_embedding_table", "make_mesh", "masked_psum_lookup",
           "param_shardings", "replicated", "shard_params"]
