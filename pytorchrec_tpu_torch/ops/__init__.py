from pytorchrec_tpu_torch.ops.attention import (
    DINAttentionPool,
    SASRecBlock,
    sasrec_encoder,
    scaled_dot_product_attention,
)
from pytorchrec_tpu_torch.ops.embedding import Embedding, normal_init
from pytorchrec_tpu_torch.ops.gru import MaskedGRU
from pytorchrec_tpu_torch.ops.interactions import (
    CrossNetworkV2,
    cross_layer_v2,
    dot_interaction,
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
    "MaskedGRU",
    "scaled_dot_product_attention",
    "SASRecBlock",
    "sasrec_encoder",
    "cross_layer_v2",
    "CrossNetworkV2",
    "DINAttentionPool",
    "dot_interaction",
    "fm_interaction",
    "fm_interaction_vector",
    "get_position_ids",
    "get_valid_his_index",
]
