from pytorchrec_tpu_torch.serving.retrieval import build_item_index, make_retrieve_fn

__all__ = ["build_item_index", "make_retrieve_fn"]
