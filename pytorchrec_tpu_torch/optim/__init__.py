from pytorchrec_tpu_torch.optim.optimizers import (
    OPTIMIZERS,
    Adagrad,
    build_optimizer,
    get_optimizer,
    optimizer_name_list,
)

__all__ = ["OPTIMIZERS", "Adagrad", "build_optimizer", "get_optimizer", "optimizer_name_list"]
