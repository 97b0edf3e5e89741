"""Model zoo and its registry (port of ``pytorchrec_tpu/models/__init__.py``):
``MODELS`` maps each of the JAX package's 24 names to (model factory, data
reader name), ``model_name_list`` lists them, ``get_model_type`` and
``get_data_reader_name`` look one up. The seven value-based RL names
(``dqn``, ``deers``, ``lsrl*``) map to their Q-network factories
(``models/rl.py``) and the ``value_rl`` reader; ``tasks/builder.py`` wraps
the network in a ``ValueRLModel``.
"""

from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.models.ctr import DLRM, FM, LR, DCNv2, DeepFM
from pytorchrec_tpu_torch.models.din import DIN
from pytorchrec_tpu_torch.models.funk_svd import FunkSVD
from pytorchrec_tpu_torch.models.gru4rec import GRU4Rec
from pytorchrec_tpu_torch.models.multitask import ESMM, MMoE, PLE, ExpertBank, SharedBottom
from pytorchrec_tpu_torch.models.ncf import NCF
from pytorchrec_tpu_torch.models.rl import (
    BranchQNet,
    DQNQNet,
    QNet,
    ValueRLModel,
    make_deers_qnet,
    make_lsrl_l_qnet,
    make_lsrl_lps_qnet,
    make_lsrl_ps_qnet,
    make_lsrl_psns_qnet,
    make_lsrl_qnet,
)
from pytorchrec_tpu_torch.models.sasrec import SASRec
from pytorchrec_tpu_torch.models.svdpp import SVDPP
from pytorchrec_tpu_torch.models.two_tower import TwoTower
from pytorchrec_tpu_torch.utils.registry import Registry

MODELS: Registry = Registry("model")

# (model factory, reader name); reader names resolve through data.readers
_MODEL_TO_READER = {
    "funksvd": (FunkSVD, "simple"),
    "ncf": (NCF, "simple"),
    "svdpp": (SVDPP, "svdpp"),
    "gru4rec": (GRU4Rec, "history"),
    "sasrec": (SASRec, "history"),
    "din": (DIN, "history"),
    "lr": (LR, "simple"),
    "fm": (FM, "simple"),
    "deepfm": (DeepFM, "ctr"),
    "dcn": (DCNv2, "ctr"),
    "dcnv2": (DCNv2, "ctr"),
    "dlrm": (DLRM, "ctr"),
    "two_tower": (TwoTower, "simple"),
    "shared_bottom": (SharedBottom, "ctr"),
    "mmoe": (MMoE, "ctr"),
    "ple": (PLE, "ctr"),
    "esmm": (ESMM, "ctr"),
    "dqn": (DQNQNet, "value_rl"),
    "deers": (make_deers_qnet, "value_rl"),
    "lsrl": (make_lsrl_qnet, "value_rl"),
    "lsrl_l": (make_lsrl_l_qnet, "value_rl"),
    "lsrl_ps": (make_lsrl_ps_qnet, "value_rl"),
    "lsrl_lps": (make_lsrl_lps_qnet, "value_rl"),
    "lsrl_psns": (make_lsrl_psns_qnet, "value_rl"),
}

for _name, (_factory, _reader) in _MODEL_TO_READER.items():
    MODELS.register(_name, (_factory, _reader))

model_name_list = list(MODELS.names())


def get_model_type(model_name: str):
    return MODELS.get(model_name)[0]


def get_data_reader_name(model_name: str) -> str:
    return MODELS.get(model_name)[1]


__all__ = ["RecModel", "BranchQNet", "DCNv2", "DeepFM", "DIN", "DLRM", "DQNQNet", "ESMM",
           "ExpertBank", "FM", "FunkSVD", "GRU4Rec", "LR", "MMoE", "NCF", "PLE", "QNet", "SASRec",
           "SVDPP", "SharedBottom", "TwoTower", "ValueRLModel",
           "MODELS", "model_name_list", "get_model_type", "get_data_reader_name"]
