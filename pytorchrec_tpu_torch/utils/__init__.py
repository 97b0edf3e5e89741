from pytorchrec_tpu_torch.utils.convert import params_from_jax
from pytorchrec_tpu_torch.utils.device import resolve_device

__all__ = ["params_from_jax", "resolve_device"]
