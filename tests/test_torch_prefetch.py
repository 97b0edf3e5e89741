"""The port's lookahead prefetch on the CPU: ``prefetch`` keeps the JAX
function's order, its sentinel and its error surfaced at the consumer (the
JAX function runs beside it on the same items), ``size=0`` takes no thread,
and the packing ring of ``device_put_prefetch`` never hands out a slot
whose last copy to the device has not completed (a fake event stands for
the card's)."""

import threading
import time

import numpy as np
import pytest
import torch

from pytorchrec_tpu.data.prefetch import prefetch as jax_prefetch
from pytorchrec_tpu_torch.data import BatchPacker, PackedBatch, device_put_prefetch, prefetch


def _count(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"batch {i}")
        yield i


@pytest.mark.parametrize("size", [0, 1, 2, 5])
def test_order_and_transform_match_jax(size):
    want = list(jax_prefetch(_count(20), size=size, transform=lambda x: x * 3))
    got = list(prefetch(_count(20), size=size, transform=lambda x: x * 3))
    assert got == want == ([i for i in range(20)] if size <= 0 else [3 * i for i in range(20)])


def test_size_zero_takes_no_thread():
    before = threading.active_count()
    items = prefetch(_count(3), size=0)
    assert next(items) == 0 and threading.active_count() == before
    assert list(items) == [1, 2]


@pytest.mark.parametrize("size", [0, 2])
def test_an_error_comes_out_at_the_consumer_after_the_items_before_it(size):
    for fn in (jax_prefetch, prefetch):
        got = []
        with pytest.raises(KeyError, match="batch 3"):
            for item in fn(_count(10, fail_at=3), size=size):
                got.append(item)
        assert got == [0, 1, 2]


def test_closing_the_consumer_stops_the_thread():
    before = set(threading.enumerate())
    items = prefetch(_count(10_000), size=2)
    assert next(items) == 0
    (thread,) = set(threading.enumerate()) - before
    items.close()
    thread.join(5)
    assert not thread.is_alive()


class _FakeEvent:
    """A copy event that completes only when the test says so."""

    def __init__(self):
        self.done = threading.Event()
        self.done.set()  # never recorded: nothing to wait for
        self.waiting = threading.Event()

    def record(self):
        self.done.clear()

    def synchronize(self):
        self.waiting.set()
        assert self.done.wait(10), "the producer waited on an event that never completed"

    def complete(self):
        self.done.set()


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"ids": rng.integers(0, 100, 8), "x": rng.normal(size=8)} for _ in range(n)]


def test_the_ring_waits_for_a_slots_copy_before_packing_into_it():
    batches = _batches(4)
    events = []

    def make_event():
        events.append(_FakeEvent())
        return events[-1]

    items = device_put_prefetch(iter(batches), size=1, make_event=make_event)  # 2 slots
    ints, floats = torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.float32)
    first = next(items)
    assert isinstance(first, PackedBatch) and len(events) == 2
    first_ints = first.ints  # slot 0
    first.copy_to(ints, floats)  # queues "the copy" of slot 0, not complete
    second = next(items)  # slot 1, packed ahead
    second.copy_to(ints, floats)
    # the producer now wants slot 0 for batch 2 and must wait for its copy
    assert events[0].waiting.wait(5)
    time.sleep(0.2)
    want = BatchPacker(batches[0]).pack(batches[0])[0]
    assert torch.equal(first_ints, want), "slot 0 was packed again before its copy completed"
    events[0].complete()
    third = next(items)
    assert third.ints.data_ptr() == first_ints.data_ptr()  # slot 0 again
    assert torch.equal(third.ints, BatchPacker(batches[2]).pack(batches[2])[0])
    events[1].complete()
    third.copy_to(ints, floats)
    events[0].complete()
    fourth = next(items)
    assert torch.equal(fourth.ints, BatchPacker(batches[3]).pack(batches[3])[0])
    fourth.copy_to(ints, floats)
    assert next(items, None) is None


def test_packed_items_and_new_layouts_pass_through():
    batches = _batches(2) + [{"ids": np.arange(4), "x": np.ones(4)}]
    packed = BatchPacker(batches[0]).pack(batches[0])
    got = list(device_put_prefetch(iter([packed] + batches), size=2))
    assert got[0] is packed
    assert got[1].packer.signature == got[2].packer.signature != got[3].packer.signature
    assert got[3].packer.int_size == 4
