"""Lookahead prefetch (port of ``pytorchrec_tpu/data/prefetch.py``):
overlap host-side batch work with device compute.

``prefetch`` runs an iterator (and an optional ``transform``) on a daemon
thread, ``size`` items ahead of the consumer, and yields them in order; an
error raised on the thread comes out at the consumer. In
``device_put_prefetch`` the thread also packs each dict batch
(``data/packing.py``) into a ring of ``size + 1`` host buffers, pinned on
the card, and the consumer queues the copy to the device
(``PackedBatch.copy_to``) on its own stream, where the step that reads it
is queued (the JAX function's ``device_put`` on the thread).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, List, Optional

import torch

from pytorchrec_tpu_torch.data.packing import BatchPacker, batch_signature

_SENTINEL = object()
_POLL_S = 0.1  # how often a blocked producer looks for the consumer's end


def prefetch(iterator: Iterator[Any], size: int = 2,
             transform: Optional[Callable[[Any], Any]] = None) -> Iterator[Any]:
    """Lookahead-prefetch an iterator via a daemon thread (``size <= 0``:
    no thread, the items as they come, untransformed as in the JAX
    function). ``transform`` runs on the thread. Closing the generator
    stops the thread."""
    if size <= 0:
        yield from iterator
        return

    buffer: "queue.Queue[Any]" = queue.Queue(maxsize=size)
    error: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                buffer.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(transform(item) if transform is not None else item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            error.append(e)
        finally:
            put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = buffer.get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()


class _HostEvent:
    """The event of a copy on the CPU, where a copy is complete when it
    returns."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


class PinnedRing:
    """``slots`` pairs of host buffers of one packer's layout, handed out in
    turn, each with the event of its last copy to the device.

    The race this closes: the copy from pinned memory is asynchronous, so
    when the consumer has queued the copy of slot i and moved on, the card
    may not have read it yet; packing the next batch into slot i then would
    change the batch that copy delivers. So ``acquire`` hands out a slot only
    after the consumer has released it (``release`` records the event after
    queueing its copy) and that event has completed."""

    def __init__(self, packer: BatchPacker, slots: int, make_event: Callable[[], Any]):
        self.packer = packer
        self.buffers = [packer.empty() for _ in range(slots)]
        self._events = [make_event() for _ in range(slots)]
        self._released = threading.Semaphore(slots)
        self._next = 0

    def acquire(self, stop: Optional[threading.Event] = None) -> Optional[int]:
        """The next slot, once its last copy has completed; None if ``stop``
        is set while waiting for the consumer to release it."""
        while not self._released.acquire(timeout=_POLL_S):
            if stop is not None and stop.is_set():
                return None
        slot, self._next = self._next, (self._next + 1) % len(self.buffers)
        self._events[slot].synchronize()
        return slot

    def release(self, slot: int) -> None:
        """After the copy of ``slot`` is queued on the current stream: record
        its event there and let the producer have the slot again."""
        self._events[slot].record()
        self._released.release()


class PackedBatch:
    """A batch packed into a ring slot: ``ints`` and ``floats`` (host
    buffers of ``packer``'s layout) until ``copy_to`` has queued their copy
    and released the slot."""

    def __init__(self, ring: PinnedRing, slot: int):
        self.packer = ring.packer
        self.ints, self.floats = ring.buffers[slot]
        self._ring, self._slot = ring, slot

    def copy_to(self, ints: torch.Tensor, floats: torch.Tensor) -> None:
        """Queue the copy into the device buffers ``ints`` and ``floats`` on
        the current stream, then release the slot."""
        ints.copy_(self.ints, non_blocking=True)
        floats.copy_(self.floats, non_blocking=True)
        self._ring.release(self._slot)


def device_put_prefetch(iterator: Iterator[Any], size: int = 2, pin_memory: bool = False,
                        make_event: Optional[Callable[[], Any]] = None) -> Iterator[Any]:
    """Prefetch that packs on the thread: each dict batch becomes a
    ``PackedBatch`` in a ring of ``size + 1`` slots (a new layout gets a new
    packer and ring); any other item (a batch packed already) passes
    through. ``pin_memory`` pins the slots (on the card), ``make_event``
    makes each slot's copy event (default ``torch.cuda.Event`` with pinned
    slots, else a host no-op). ``size <= 0`` packs on the consumer's
    thread into a ring of one slot."""
    if make_event is None:
        make_event = torch.cuda.Event if pin_memory else _HostEvent
    rings: List[PinnedRing] = []
    stop = threading.Event()

    def pack(item):
        if not isinstance(item, dict):
            return item
        if not rings or rings[0].packer.signature != batch_signature(item):
            rings[:] = [PinnedRing(BatchPacker(item, pin_memory), max(size, 0) + 1, make_event)]
        ring = rings[0]
        slot = ring.acquire(stop)
        if slot is None:
            return item
        ring.packer.pack(item, out=ring.buffers[slot])
        return PackedBatch(ring, slot)

    items = prefetch(iterator, size=size, transform=pack) if size > 0 else map(pack, iterator)
    try:
        yield from items
    finally:
        stop.set()
        if hasattr(items, "close"):
            items.close()
