"""Reader registry (port of ``pytorchrec_tpu/data/readers/__init__.py``):
name -> reader class. ``"ctr"`` is the feature-loading variant of the simple
reader (DeepFM/DCN-style models need the dense and sparse feature columns
carried through). The RL reader comes with the RL models.
"""

from __future__ import annotations

from pytorchrec_tpu_torch.data.readers.base import DataReader
from pytorchrec_tpu_torch.data.readers.history import HistoryDataReader
from pytorchrec_tpu_torch.data.readers.svdpp import SVDPPDataReader
from pytorchrec_tpu_torch.utils.registry import Registry

# "simple" is the base reader
SimpleDataReader = DataReader


class CTRDataReader(DataReader):
    """Simple reader defaulting to feature loading (dense + sparse columns)."""

    def __init__(self, *args, load_feature: bool = True, **kwargs):
        super().__init__(*args, load_feature=load_feature, **kwargs)


READERS: Registry = Registry("data_reader")
READERS.register("simple", SimpleDataReader)
READERS.register("history", HistoryDataReader)
READERS.register("svdpp", SVDPPDataReader)
READERS.register("ctr", CTRDataReader)

data_reader_name_list = list(READERS.names())


def get_data_reader_type(name: str):
    return READERS.get(name)


__all__ = [
    "DataReader",
    "SimpleDataReader",
    "HistoryDataReader",
    "SVDPPDataReader",
    "CTRDataReader",
    "READERS",
    "data_reader_name_list",
    "get_data_reader_type",
]
