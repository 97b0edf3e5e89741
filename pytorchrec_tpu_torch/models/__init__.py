from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.models.ctr import DCNv2

__all__ = ["RecModel", "DCNv2"]
