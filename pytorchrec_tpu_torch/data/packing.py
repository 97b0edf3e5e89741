"""Packed batch transfer (port of ``pytorchrec_tpu/data/packing.py``): one
host-to-device copy per dtype group.

A CTR batch is some 40 small named arrays; copying each on its own pays a
copy's fixed cost 40 times a step. The packer concatenates every integer
column into ONE int32 buffer and every float column into ONE float32
buffer, with offsets fixed by the example batch, so a step copies two
buffers, and the step reads its columns back as views at those offsets
(``unpack``: no copy, so a CUDA graph of the step reads whatever the
buffers hold at replay).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

Batch = Dict[str, Any]


class _Slot(NamedTuple):
    key: str
    offset: int
    size: int
    shape: Tuple[int, ...]


def _layout(value) -> Tuple[Tuple[int, ...], bool]:
    """(shape, whether it is a float column) of a numpy array or a tensor."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), value.dtype.is_floating_point
    array = np.asarray(value)
    return array.shape, bool(np.issubdtype(array.dtype, np.floating))


def batch_signature(batch: Batch) -> tuple:
    """What fixes a packer's layout: each key's shape and kind (int or
    float), in sorted key order."""
    return tuple((key, *_layout(batch[key])) for key in sorted(batch))


class BatchPacker:
    """Built from one example batch (numpy arrays or tensors); ``pack`` on the
    host, ``unpack`` where the step runs. ``pin_memory`` puts the packed host
    buffers in page-locked memory (the card's asynchronous copies need it)."""

    def __init__(self, example: Batch, pin_memory: bool = False):
        self.int_slots: List[_Slot] = []
        self.float_slots: List[_Slot] = []
        self.signature = batch_signature(example)
        self.pin_memory = pin_memory
        int_off = float_off = 0
        for key, shape, is_float in self.signature:
            size = int(np.prod(shape, dtype=np.int64))
            if is_float:
                self.float_slots.append(_Slot(key, float_off, size, shape))
                float_off += size
            else:
                self.int_slots.append(_Slot(key, int_off, size, shape))
                int_off += size
        self.int_size = int_off
        self.float_size = float_off

    def empty(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """A pair of host buffers of this layout (pinned where asked)."""
        return (torch.empty(self.int_size, dtype=torch.int32, pin_memory=self.pin_memory),
                torch.empty(self.float_size, dtype=torch.float32, pin_memory=self.pin_memory))

    def pack(self, batch: Batch, out=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's int32 and float32 buffers: ``out`` (a pair of 1-D
        buffers of this layout on any device) written in place, else a new
        host pair. Values cast as numpy assigns them (int64 ids wrap to
        int32, float64 rounds to float32)."""
        ints, floats = self.empty() if out is None else out
        for slots, buffer in ((self.int_slots, ints), (self.float_slots, floats)):
            # host buffers take numpy columns through a numpy view: one numpy
            # assignment a column instead of four torch calls
            view = buffer.numpy() if buffer.device.type == "cpu" else None
            for slot in slots:
                value = batch[slot.key]
                if view is not None and not isinstance(value, torch.Tensor):
                    view[slot.offset:slot.offset + slot.size] = np.asarray(value).reshape(-1)
                else:
                    value = torch.as_tensor(value)
                    buffer[slot.offset:slot.offset + slot.size].copy_(value.reshape(-1))
        return ints, floats

    def unpack(self, ints: torch.Tensor, floats: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch as views of the two buffers at static offsets: no copy."""
        batch: Dict[str, torch.Tensor] = {}
        for slots, buffer in ((self.int_slots, ints), (self.float_slots, floats)):
            for slot in slots:
                batch[slot.key] = buffer[slot.offset:slot.offset + slot.size].view(slot.shape)
        return batch
