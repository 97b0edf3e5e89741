from pytorchrec_tpu_torch.optim.optimizers import OPTIMIZERS, build_optimizer

__all__ = ["OPTIMIZERS", "build_optimizer"]
