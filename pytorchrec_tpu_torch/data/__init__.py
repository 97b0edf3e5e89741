"""Host data path of the port (port of ``pytorchrec_tpu/data``): datasets as
numpy frames (``process/io.py``), the processing pipeline (``process``:
splits, negatives, histories), the synthetic generators and the raw
formatters (``process/datasets``), the readers (``readers``:
simple, CTR, history, SVD++, value RL) and the dataset description (``schema.py``);
the fixed-shape epoch batches over a reader (``loader.py``), the packed
batch transfer (``packing.py``) and the lookahead prefetch
(``prefetch.py``); the streaming source over sharded files
(``streaming.py``) and the frequency vocabs (``vocab.py``)."""

from pytorchrec_tpu_torch.data.schema import DatasetDescription, FeatureMeta, SplitMode, TrainMode
from pytorchrec_tpu_torch.data.readers import (
    CTRDataReader,
    DataReader,
    HistoryDataReader,
    READERS,
    SVDPPDataReader,
    SimpleDataReader,
    ValueRLDataReader,
    data_reader_name_list,
    get_data_reader_type,
)
from pytorchrec_tpu_torch.data.loader import eval_batches, num_train_batches, train_batches
from pytorchrec_tpu_torch.data.packing import BatchPacker, batch_signature
from pytorchrec_tpu_torch.data.prefetch import (
    PackedBatch,
    PinnedRing,
    device_put_prefetch,
    prefetch,
)
from pytorchrec_tpu_torch.data.process.datasets import generate_synthetic_ctr, generate_synthetic_ml
from pytorchrec_tpu_torch.data.process.io import frames_from_feather, read_frame, write_frame

__all__ = ["BatchPacker", "CTRDataReader", "DataReader", "DatasetDescription", "FeatureMeta",
           "HistoryDataReader", "PackedBatch", "PinnedRing", "READERS", "SVDPPDataReader",
           "SimpleDataReader", "SplitMode", "TrainMode", "ValueRLDataReader", "batch_signature",
           "data_reader_name_list", "device_put_prefetch", "eval_batches",
           "frames_from_feather", "generate_synthetic_ctr", "generate_synthetic_ml",
           "get_data_reader_type", "num_train_batches", "prefetch", "read_frame",
           "train_batches", "write_frame"]
