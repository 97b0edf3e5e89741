from pytorchrec_tpu_torch.ops.attention import DINAttentionPool
from pytorchrec_tpu_torch.ops.embedding import Embedding, normal_init
from pytorchrec_tpu_torch.ops.interactions import (
    CrossNetworkV2,
    cross_layer_v2,
    fm_interaction,
    fm_interaction_vector,
)
from pytorchrec_tpu_torch.ops.mlp import MLP, Dense
from pytorchrec_tpu_torch.ops.seq_utils import get_position_ids, get_valid_his_index

__all__ = [
    "Embedding",
    "normal_init",
    "Dense",
    "MLP",
    "cross_layer_v2",
    "CrossNetworkV2",
    "DINAttentionPool",
    "fm_interaction",
    "fm_interaction_vector",
    "get_position_ids",
    "get_valid_his_index",
]
