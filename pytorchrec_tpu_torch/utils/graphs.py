"""One CUDA graph per request shape: the port's twin of a ``jax.jit`` that
scores (``Trainer``'s scorer, ``serving/retrieval.py``'s retrieve function).

A ``GraphCache`` keeps, for each key (a request's shape), static device
inputs and a CUDA graph that reads them:

* the first request of a key runs the body eagerly, on the stream the
  captures use (the warm-up: cuBLAS handles, kernel attributes);
* the second captures the body into a graph, and it and every later request
  replay it. The graphs of one cache share one memory pool: they never run
  at the same time, and every output is copied out before the call returns,
  so a replay may take over memory another graph's outputs used;
* each request is copied into the static inputs first, on the current
  stream, and the outputs are copied out into fresh tensors last, so the
  next request cannot overwrite a result already returned.

Kernel launches made while a graph is captured go to its tally, and each
replay adds the tally to the counts (``ops/kernels/__init__.py``), so a
request counts the same launches whether it ran eagerly or replayed. A
capture or a replay that fails raises; nothing falls back to the eager body.
On the CPU the body runs eagerly over the same static inputs every time, and
the outputs are copied out in the same way.

A host request reaches the card through pinned buffers (``StaticInputs``):
one set a key, refilled only once the event of its last copy has passed,
so the host never overwrites a request the card has not read yet.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from pytorchrec_tpu_torch.ops.kernels import add_tally, capture_tally

Outputs = Tuple[Optional[torch.Tensor], ...]


@contextlib.contextmanager
def collector_paused():
    """Collect Python's cyclic garbage, then keep the collector off while a
    graph is captured: garbage that holds a CUDA graph or its memory pool,
    freed by the collector in the middle of a capture, invalidates the
    capture (cuBLAS then fails inside it)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def on_device(values) -> bool:
    """Whether any of ``values`` is a tensor on an accelerator."""
    return any(isinstance(v, torch.Tensor) and v.device.type != "cpu" for v in values)


class StaticInputs:
    """Static device buffers that a request is copied into: a host request
    through pinned twins of the buffers on the card, a request already on
    the device (or anything on the CPU) directly. ``write(request,
    buffers)`` puts a request into buffers of the static inputs' shapes and
    dtypes. The pinned twins are refilled only once the event of their last
    copy to the card has passed."""

    def __init__(self, buffers: Sequence[torch.Tensor],
                 write: Callable[[Any, List[torch.Tensor]], None]):
        self.buffers = list(buffers)
        self._write = write
        self._host: Optional[List[torch.Tensor]] = None
        if self.buffers[0].device.type == "cuda":
            self._host = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                          for b in self.buffers]
            self._copied = torch.cuda.Event()

    def load(self, request: Any, values) -> None:
        """Copy ``request`` (whose tensors are ``values``) in, on the current
        stream."""
        if self._host is None or on_device(values):
            self._write(request, self.buffers)
            return
        self._copied.synchronize()  # returns at once before the first record
        self._write(request, self._host)
        for device_buffer, host in zip(self.buffers, self._host):
            device_buffer.copy_(host, non_blocking=True)
        self._copied.record()


class _Entry:
    def __init__(self, inputs: Any):
        self.inputs = inputs
        self.warm = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally: Dict[Callable, int] = {}
        self.outputs: Outputs = ()


class GraphCache:
    """Keyed CUDA graphs of one body over each key's static inputs (see the
    module docstring). ``run(key, load, make_inputs, body)``: ``make_inputs()``
    builds a new key's static inputs, ``load(inputs)`` copies the request
    into them, and ``body(inputs)`` returns a tuple of output tensors (or
    None), run under ``torch.inference_mode()``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._entries: Dict[Hashable, _Entry] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def __len__(self) -> int:
        return len(self._entries)

    def graphs(self) -> int:
        """How many keys have a captured graph."""
        return sum(entry.graph is not None for entry in self._entries.values())

    def tally(self, key: Hashable) -> Dict[Callable, int]:
        """The launches a replay of ``key``'s graph adds."""
        return dict(self._entries[key].tally)

    def inputs(self, key: Hashable) -> Any:
        return self._entries[key].inputs

    def replay(self, key: Hashable) -> None:
        """Replay ``key``'s captured graph over the inputs it holds, and add
        its tally: a request's device work without its copies (for timing)."""
        entry = self._entries[key]
        entry.graph.replay()
        add_tally(entry.tally)

    def clear(self) -> None:
        """Drop every key's static inputs and graph (the body's parameters
        were replaced, or the caller is done)."""
        self._entries.clear()

    def run(self, key: Hashable, load: Callable[[Any], None], make_inputs: Callable[[], Any],
            body: Callable[[Any], Outputs]) -> Outputs:
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(make_inputs())
        load(entry.inputs)
        with torch.inference_mode():
            outputs = self._outputs(entry, body)
        return tuple(None if t is None else t.clone() for t in outputs)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _outputs(self, entry: _Entry, body: Callable[[Any], Outputs]) -> Outputs:
        if self.device.type != "cuda":
            return body(entry.inputs)
        if not entry.warm:
            stream = self._side_stream()
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                outputs = body(entry.inputs)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            entry.warm = True
            return outputs
        if entry.graph is None:
            self._capture(entry, body)
        entry.graph.replay()
        add_tally(entry.tally)
        return entry.outputs

    def _capture(self, entry: _Entry, body: Callable[[Any], Outputs]) -> None:
        """Capture ``body`` over the entry's inputs into the cache's pool. A
        capture that fails raises; PyTorch then leaves the generators it
        registered (its default CUDA generator among them) in capture mode,
        and the process cannot draw from them again."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with collector_paused(), capture_tally() as tally:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._side_stream(),
                                  capture_error_mode="thread_local"):
                outputs = body(entry.inputs)
        entry.graph, entry.tally, entry.outputs = graph, dict(tally), outputs
