"""Host data path of the port (port of ``pytorchrec_tpu/data``): the packed
batch transfer (``packing.py``) and the lookahead prefetch
(``prefetch.py``). The readers, schema, loader, vocab, streaming and
processing modules are not ported yet."""

from pytorchrec_tpu_torch.data.packing import BatchPacker, batch_signature
from pytorchrec_tpu_torch.data.prefetch import (
    PackedBatch,
    PinnedRing,
    device_put_prefetch,
    prefetch,
)

__all__ = ["BatchPacker", "PackedBatch", "PinnedRing", "batch_signature",
           "device_put_prefetch", "prefetch"]
