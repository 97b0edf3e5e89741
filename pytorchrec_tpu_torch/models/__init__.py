from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.models.ctr import FM, LR, DCNv2, DeepFM

__all__ = ["RecModel", "DCNv2", "DeepFM", "FM", "LR"]
