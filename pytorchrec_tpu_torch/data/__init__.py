"""Host data path of the port (port of ``pytorchrec_tpu/data``): the packed
batch transfer (``packing.py``), the lookahead prefetch (``prefetch.py``),
the fixed-shape epoch batches over a reader (``loader.py``) and the split
and train modes (``schema.py``). The readers, the dataset description,
vocab, streaming and processing modules are not ported yet."""

from pytorchrec_tpu_torch.data.loader import eval_batches, num_train_batches, train_batches
from pytorchrec_tpu_torch.data.packing import BatchPacker, batch_signature
from pytorchrec_tpu_torch.data.prefetch import (
    PackedBatch,
    PinnedRing,
    device_put_prefetch,
    prefetch,
)
from pytorchrec_tpu_torch.data.schema import SplitMode, TrainMode

__all__ = ["BatchPacker", "PackedBatch", "PinnedRing", "batch_signature",
           "device_put_prefetch", "eval_batches", "num_train_batches", "prefetch",
           "SplitMode", "train_batches", "TrainMode"]
