"""Model zoo and its registry (port of ``pytorchrec_tpu/models/__init__.py``):
``MODELS`` maps each of the JAX package's 24 names to (model factory, data
reader name), ``model_name_list`` lists them, ``get_model_type`` and
``get_data_reader_name`` look one up.

The seven value-based RL names (``dqn``, ``deers``, ``lsrl*``) and their
``value_rl`` reader stay in the registry, so the names and the CLI's
choices are the JAX package's; building one raises
``NotImplementedError`` naming the modules still to port.
"""

from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.models.ctr import DLRM, FM, LR, DCNv2, DeepFM
from pytorchrec_tpu_torch.models.din import DIN
from pytorchrec_tpu_torch.models.funk_svd import FunkSVD
from pytorchrec_tpu_torch.models.gru4rec import GRU4Rec
from pytorchrec_tpu_torch.models.multitask import ESMM, MMoE, PLE, ExpertBank, SharedBottom
from pytorchrec_tpu_torch.models.ncf import NCF
from pytorchrec_tpu_torch.models.sasrec import SASRec
from pytorchrec_tpu_torch.models.svdpp import SVDPP
from pytorchrec_tpu_torch.models.two_tower import TwoTower
from pytorchrec_tpu_torch.utils.registry import Registry

RL_MISSING = ("models/rl.py, training/rl_trainer.py, data/readers/value_rl.py and "
              "data/process/rl_sample.py")


def _rl_model(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"RL model {name!r} is not ported yet: it needs {RL_MISSING}")

    build.__name__ = f"rl_{name}"
    return build


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
    **{name: (_rl_model(name), "value_rl")
       for name in ("dqn", "deers", "lsrl", "lsrl_l", "lsrl_ps", "lsrl_lps", "lsrl_psns")},
}

for _name, (_factory, _reader) in _MODEL_TO_READER.items():
    MODELS.register(_name, (_factory, _reader))

model_name_list = list(MODELS.names())


def get_model_type(model_name: str):
    return MODELS.get(model_name)[0]


def get_data_reader_name(model_name: str) -> str:
    return MODELS.get(model_name)[1]


__all__ = ["RecModel", "DCNv2", "DeepFM", "DIN", "DLRM", "ESMM", "ExpertBank", "FM", "FunkSVD",
           "GRU4Rec", "LR", "MMoE", "NCF", "PLE", "SASRec", "SVDPP", "SharedBottom", "TwoTower",
           "MODELS", "model_name_list", "get_model_type", "get_data_reader_name"]
