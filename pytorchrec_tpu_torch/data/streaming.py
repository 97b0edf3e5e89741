"""Streaming input pipeline for datasets that do not fit in host RAM (port
of ``pytorchrec_tpu/data/streaming.py``).

Rows stream from sharded files, chunk by chunk, on a producer thread:

* up to ``interleave_files`` files are read round-robin, so consecutive
  chunks come from different shards;
* chunks are shuffled together in a buffer of ``shuffle_buffer_chunks`` and
  cut into fixed-shape batches (the remainder is dropped at the epoch's
  end), so a captured step never sees a new shape;
* each epoch reshuffles the file order; process p of n reads
  ``files[p::n]``.

The generator draws are the JAX package's, in its order
(``default_rng(seed + process_id)``, ``shuffle(files)`` each epoch,
``permutation(n)`` each drain), so over the same rows both yield the same
batches byte for byte.

File kinds, without pandas or pyarrow (the card's machine has neither):

* ``.npz``: the port's frames (``data/process/io.py::read_frame``), the
  columns asked for in their asked order, cut into ``chunk_rows`` slices;
* ``.csv`` (``,``), ``.tsv`` and ``.txt`` (tab): a header row of names, then
  ``chunk_rows`` rows a chunk, each column typed as ``pandas.read_csv``
  types it in that chunk (``read_csv_chunks``, ``data/process/text.py``);
* ``.parquet`` and ``.feather`` raise: write ``.npz`` frames instead
  (``format_criteo`` writes its shards so).

Use with ``Trainer.fit_steps`` (step-driven, no dataset length needed).
"""

from __future__ import annotations

import glob
import logging
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from pytorchrec_tpu_torch.data.process.io import read_frame
from pytorchrec_tpu_torch.data.process.text import split_fields, text_lines, typed_column

logger = logging.getLogger(__name__)

Batch = Dict[str, np.ndarray]


def _numeric_column(name: str, strings: Sequence[str]) -> np.ndarray:
    column = typed_column(strings)
    if column.dtype == object:
        raise ValueError(f"column {name!r} holds text; the streaming source reads numeric "
                         f"columns")
    return column


def read_csv_chunks(path: str, sep: str, chunk_rows: int,
                    columns: Optional[Sequence[str]] = None) -> Iterator[Batch]:
    """What ``pd.read_csv(path, sep=sep, chunksize=chunk_rows,
    usecols=columns)`` yields, as column dicts: the first line names the
    columns; the columns asked for come in the file's order; each chunk
    types its columns on its own (``data/process/text.py::typed_column``;
    a text column raises)."""
    with open(path, newline="") as f:
        header = f.readline().rstrip("\r\n")
        names = header.split(sep)
        if columns is not None:
            absent = [c for c in columns if c not in names]
            if absent:
                raise ValueError(f"{path}: columns {absent} are not in the header {names}")
            wanted = [i for i, name in enumerate(names) if name in set(columns)]
        else:
            wanted = list(range(len(names)))
        first_line = 2
        for lines in text_lines(f, chunk_rows):
            rows = split_fields(lines, sep, len(names), first_line,
                                cut_longer=columns is not None)
            first_line += len(lines)
            fields = list(zip(*rows))
            yield {names[i]: _numeric_column(names[i], fields[i]) for i in wanted}


class StreamingBatchSource:
    """Fixed-shape batch stream over sharded columnar files."""

    def __init__(
        self,
        file_pattern: str | Sequence[str],
        batch_size: int,
        columns: Optional[Sequence[str]] = None,
        chunk_rows: int = 262_144,
        shuffle_buffer_chunks: int = 4,
        shuffle_files: bool = True,
        interleave_files: int = 4,
        seed: int = 2020,
        process_id: int = 0,
        process_count: int = 1,
        queue_depth: int = 4,
        transform: Optional[Callable[[Batch], Batch]] = None,
    ):
        if isinstance(file_pattern, str):
            files = sorted(glob.glob(file_pattern))
        else:
            files = list(file_pattern)
        assert files, f"no files match {file_pattern!r}"
        for path in files:
            if path.endswith((".parquet", ".feather")):
                raise ValueError(f"{path}: parquet and feather need pyarrow, which the port does "
                                 f"not use; write the shards as .npz frames "
                                 f"(data/process/io.py::write_frame)")
        # per-host shard: process p reads files[p::n]
        self.files: List[str] = files[process_id::process_count]
        assert self.files, (
            f"process {process_id}/{process_count} got no files "
            f"({len(files)} total) — need at least one file per process"
        )
        self.batch_size = batch_size
        self.columns = list(columns) if columns else None
        self.chunk_rows = chunk_rows
        self.shuffle_buffer_chunks = shuffle_buffer_chunks
        self.shuffle_files = shuffle_files
        self.interleave_files = max(1, interleave_files)
        self.rng = np.random.default_rng(seed + process_id)
        self.queue_depth = queue_depth
        # a chunk's column transform (e.g. data.vocab.VocabMapper), run on the
        # producer thread before batching, so batch shapes stay fixed
        self.transform = transform

    # ------------------------------------------------------------------

    def _read_file_chunks(self, path: str) -> Iterator[Batch]:
        if path.endswith(".npz"):
            frame = read_frame(path)
            names = self.columns if self.columns is not None else list(frame)
            absent = [c for c in names if c not in frame]
            if absent:
                raise ValueError(f"{path}: columns {absent} are not in the frame {list(frame)}")
            n = len(frame[names[0]]) if names else 0
            for start in range(0, n, self.chunk_rows):
                yield {name: frame[name][start:start + self.chunk_rows] for name in names}
        else:  # csv / tsv
            sep = "\t" if path.endswith((".tsv", ".txt")) else ","
            yield from read_csv_chunks(path, sep, self.chunk_rows, self.columns)

    def _epoch_chunks(self) -> Iterator[Batch]:
        """Round-robin over up to ``interleave_files`` open files, so
        consecutive chunks come from different shards (a cheap global mix
        before the shuffle buffer)."""
        files = list(self.files)
        if self.shuffle_files:
            self.rng.shuffle(files)
        pending = files[::-1]  # pop() order = shuffled order
        open_iters: List[Iterator[Batch]] = []
        while pending and len(open_iters) < self.interleave_files:
            open_iters.append(self._read_file_chunks(pending.pop()))
        while open_iters:
            for it in list(open_iters):
                chunk = next(it, None)
                if chunk is None:
                    open_iters.remove(it)
                    if pending:
                        open_iters.append(self._read_file_chunks(pending.pop()))
                    continue
                columns = {name: np.ascontiguousarray(values) for name, values in chunk.items()}
                if self.transform is not None:
                    columns = self.transform(columns)
                yield columns

    def batches(self, epochs: Optional[int] = None) -> Iterator[Batch]:
        """Yield fixed-shape batches; ``epochs=None`` streams forever. An
        error on the producer thread is raised here; closing the generator
        (or dropping it) ends the producer thread."""
        out: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        stop = object()
        error: list = []
        closed = threading.Event()

        def put(item) -> None:
            while not closed.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue
            raise _Closed

        def producer():
            try:
                epoch = 0
                while epochs is None or epoch < epochs:
                    buffer: List[Batch] = []
                    carry: Optional[Batch] = None
                    for chunk in self._epoch_chunks():
                        buffer.append(chunk)
                        if len(buffer) >= self.shuffle_buffer_chunks:
                            carry = self._drain(buffer, carry, put)
                            buffer = []
                    self._drain(buffer, carry, put, final=True)
                    epoch += 1
            except _Closed:
                return
            except BaseException as e:
                error.append(e)
            try:
                put(stop)
            except _Closed:
                pass

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out.get()
                if item is stop:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            closed.set()

    def _drain(self, buffer: List[Batch], carry: Optional[Batch], put: Callable[[Batch], None],
               final: bool = False) -> Optional[Batch]:
        """Shuffle the buffered chunks together, emit full batches, keep the
        remainder as the carry (dropped at the epoch's end)."""
        parts = ([carry] if carry is not None else []) + buffer
        if not parts:
            return None
        keys = parts[0].keys()
        merged = {k: np.concatenate([p[k] for p in parts]) for k in keys}
        n = len(next(iter(merged.values())))
        order = self.rng.permutation(n)
        merged = {k: v[order] for k, v in merged.items()}
        n_batches = n // self.batch_size
        for b in range(n_batches):
            start = b * self.batch_size
            put({k: v[start:start + self.batch_size] for k, v in merged.items()})
        if final:
            return None
        rest = n_batches * self.batch_size
        return {k: v[rest:] for k, v in merged.items()}


class _Closed(Exception):
    """The consumer closed the stream: the producer thread ends."""
