"""Multi-device training (port of ``pytorchrec_tpu/parallel``): the
``(data, model)`` mesh on ``torch.distributed`` and its axes by name inside
``bound(mesh)``, with ``all_gather_grad`` (``mesh.py``), the
parameter sharding rules (``sharding.py``), the sharded lookups and the
all-to-all row-gradient exchanges (``embedding_engine.py``), the hot/cold
layout (``hot_cold.py``) and int8 dense-gradient means
(``grad_compression.py``)."""

from pytorchrec_tpu_torch.parallel.embedding_engine import (
    all_to_all_lookup,
    all_to_all_rowgrad,
    bucket_capacity,
    grid_lookup,
    grid_rowgrad,
    make_sharded_lookup,
    masked_psum_lookup,
    two_hop_lookup,
    two_hop_rowgrad,
)
from pytorchrec_tpu_torch.parallel.grad_compression import (
    compressed_pmean_flat,
    compressed_wire_bytes,
    select_compressible,
)
from pytorchrec_tpu_torch.parallel.hot_cold import (
    HotColdLayout,
    build_layout,
    hot_cold_lookup,
    make_hot_cold_lookup,
    merge_table,
    split_table,
)
from pytorchrec_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_gather_grad,
    bound,
    bound_mesh,
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

__all__ = ["DATA_AXIS", "HotColdLayout", "MODEL_AXIS", "Mesh", "RowShard", "all_gather_grad",
           "all_to_all_lookup", "all_to_all_rowgrad", "bound", "bound_mesh", "bucket_capacity",
           "build_layout", "compressed_pmean_flat",
           "compressed_wire_bytes", "data_sharding", "grid_lookup", "grid_rowgrad",
           "hot_cold_lookup", "initialize_distributed", "is_embedding_table",
           "make_hot_cold_lookup", "make_mesh", "make_sharded_lookup", "masked_psum_lookup",
           "merge_table", "param_shardings", "replicated", "select_compressible", "shard_params",
           "split_table", "two_hop_lookup", "two_hop_rowgrad"]
