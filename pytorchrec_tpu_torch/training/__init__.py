from pytorchrec_tpu_torch.training.trainer import Trainer

__all__ = ["Trainer"]
