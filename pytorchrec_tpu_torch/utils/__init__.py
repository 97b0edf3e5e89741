from pytorchrec_tpu_torch.utils.convert import params_from_jax
from pytorchrec_tpu_torch.utils.device import resolve_device
from pytorchrec_tpu_torch.utils.timer import Timer
from pytorchrec_tpu_torch.utils.version import environment_summary

__all__ = ["Timer", "environment_summary", "params_from_jax", "resolve_device"]
