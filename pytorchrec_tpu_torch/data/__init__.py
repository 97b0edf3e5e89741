"""Host data path of the port (port of ``pytorchrec_tpu/data``): the packed
batch transfer (``packing.py``), the lookahead prefetch (``prefetch.py``)
and the fixed-shape epoch batches over a reader (``loader.py``). The
readers, schema, vocab, streaming and processing modules are not ported
yet."""

from pytorchrec_tpu_torch.data.loader import eval_batches, num_train_batches, train_batches
from pytorchrec_tpu_torch.data.packing import BatchPacker, batch_signature
from pytorchrec_tpu_torch.data.prefetch import (
    PackedBatch,
    PinnedRing,
    device_put_prefetch,
    prefetch,
)

__all__ = ["BatchPacker", "PackedBatch", "PinnedRing", "batch_signature",
           "device_put_prefetch", "eval_batches", "num_train_batches", "prefetch",
           "train_batches"]
