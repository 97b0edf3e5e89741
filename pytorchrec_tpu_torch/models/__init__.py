from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.models.ctr import FM, LR, DCNv2, DeepFM
from pytorchrec_tpu_torch.models.din import DIN

__all__ = ["RecModel", "DCNv2", "DeepFM", "DIN", "FM", "LR"]
