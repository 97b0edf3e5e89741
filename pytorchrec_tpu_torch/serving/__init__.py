"""Serving: full-corpus retrieval for two-tower models (``retrieval.py``)
and the serving bundle for the Python-free server (``bundle.py``)."""

from pytorchrec_tpu_torch.serving.bundle import export_serving_bundle, shim_binary_path
from pytorchrec_tpu_torch.serving.retrieval import build_item_index, make_retrieve_fn

__all__ = ["build_item_index", "export_serving_bundle", "make_retrieve_fn", "shim_binary_path"]
