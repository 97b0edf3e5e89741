from pytorchrec_tpu_torch.loss.losses import (
    LOSSES,
    bce_loss,
    bpr_loss,
    esmm_loss,
    get_loss,
    loss_name_list,
    mse_loss,
    softmax_ce_loss,
    top1_loss,
)

__all__ = ["LOSSES", "bce_loss", "bpr_loss", "esmm_loss", "get_loss", "loss_name_list",
           "mse_loss", "softmax_ce_loss", "top1_loss"]
