from pytorchrec_tpu_torch.ops.embedding import Embedding, normal_init
from pytorchrec_tpu_torch.ops.interactions import (
    CrossNetworkV2,
    cross_layer_v2,
    fm_interaction,
    fm_interaction_vector,
)
from pytorchrec_tpu_torch.ops.mlp import MLP, Dense

__all__ = [
    "Embedding",
    "normal_init",
    "Dense",
    "MLP",
    "cross_layer_v2",
    "CrossNetworkV2",
    "fm_interaction",
    "fm_interaction_vector",
]
