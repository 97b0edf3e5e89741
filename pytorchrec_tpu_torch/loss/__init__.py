from pytorchrec_tpu_torch.loss.losses import (
    LOSSES,
    bce_loss,
    bpr_loss,
    get_loss,
    mse_loss,
    softmax_ce_loss,
)

__all__ = ["LOSSES", "bce_loss", "bpr_loss", "mse_loss", "softmax_ce_loss", "get_loss"]
