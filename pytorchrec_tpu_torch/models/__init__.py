from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.models.ctr import FM, LR, DCNv2, DeepFM
from pytorchrec_tpu_torch.models.din import DIN
from pytorchrec_tpu_torch.models.two_tower import TwoTower

__all__ = ["RecModel", "DCNv2", "DeepFM", "DIN", "FM", "LR", "TwoTower"]
