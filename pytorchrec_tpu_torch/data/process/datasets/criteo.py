"""Criteo click-log formatter, Kaggle/Terabyte TSV format (port of
``pytorchrec_tpu/data/process/datasets/criteo.py``), without pandas.

Raw rows are ``label \\t I1..I13 \\t C1..C26``: the integer features may be
missing or negative, the categorical ones are 32-bit hex strings (or
missing). The DLRM preparation:

* ``label``: missing -> 0, int32;
* dense ``d_0..d_12``: a value that does not parse as a number, or is
  missing, -> 0; negatives -> 0; then ``log1p`` in float64, served as
  float32;
* sparse ``c_0..c_25``: hex -> int, scrambled by ``splitmix64`` and hashed
  into ``[1, hash_bucket)``, 0 for missing; int32.

The TSV is read ``chunk_rows`` lines at a time, as ``pd.read_csv(sep="\\t",
header=None, dtype=str, chunksize=chunk_rows)`` reads it: blank lines are
skipped, the first line sets the number of fields, a short line is padded
with missing fields, and a field is missing when it is empty or one of
pandas' missing-value strings (``data/process/text.py``). The
output is sharded ``.npz`` frames ``<dataset>/shards/part-%05d.npz``
(columns ``label``, ``d_*``, ``c_*``), flushed a whole chunk at a time as
the JAX package flushes its parquet shards, so the shards hold the same
rows; the description files; and, with ``sample_rows``, the canonical
frames of the first rows for the reader path.
"""

from __future__ import annotations

import logging
import os
from itertools import islice
from typing import Iterator, List, Optional, Sequence

import numpy as np

from pytorchrec_tpu_torch.data.process.io import Frame, frame_rows, write_frame
from pytorchrec_tpu_torch.data.schema import DatasetDescription, FeatureMeta
from pytorchrec_tpu_torch.data.process.text import missing_mask
from pytorchrec_tpu_torch.data.vocab import splitmix64
from pytorchrec_tpu_torch.utils import constants as C

logger = logging.getLogger(__name__)

N_DENSE = 13
N_SPARSE = 26
N_FIELDS = 1 + N_DENSE + N_SPARSE

_HEX_DIGITS = np.full(256, 255, dtype=np.uint8)
_HEX_DIGITS[np.frombuffer(b"0123456789", np.uint8)] = np.arange(10)
_HEX_DIGITS[np.frombuffer(b"abcdef", np.uint8)] = np.arange(10, 16)
_HEX_DIGITS[np.frombuffer(b"ABCDEF", np.uint8)] = np.arange(10, 16)
_HEX_WIDTH = 16  # hex digits of a uint64
_DECIMAL_DIGITS = np.full(256, 255, dtype=np.uint8)
_DECIMAL_DIGITS[np.frombuffer(b"0123456789", np.uint8)] = np.arange(10)
_DECIMAL_WIDTH = 18  # decimal digits an int64 always holds
_TAB, _NEWLINE, _MINUS = ord("\t"), ord("\n"), ord("-")


def parse_labels(fields: Sequence[str]) -> np.ndarray:
    """``fillna(0).astype(np.int32)``: a missing label is 0."""
    values = np.asarray(fields, dtype=np.str_)
    values[missing_mask(values)] = "0"
    return values.astype(np.int32)


def _to_number(text: str) -> float:
    try:
        return float(text)
    except ValueError:
        return np.nan


def _log1p_clipped(numbers: np.ndarray) -> np.ndarray:
    numbers[np.isnan(numbers)] = 0.0
    return np.log1p(np.clip(numbers, 0, None)).astype(np.float32)


def parse_dense(fields: Sequence[str]) -> np.ndarray:
    """``pd.to_numeric(errors="coerce").fillna(0)``, clipped at 0,
    ``log1p`` in float64, as float32."""
    values = np.asarray(fields, dtype=np.str_)
    missing = missing_mask(values)
    numbers = np.array([np.nan if m else _to_number(s)
                        for s, m in zip(values.tolist(), missing.tolist())], dtype=np.float64)
    return _log1p_clipped(numbers)


def _hex_python(values: Sequence[str]) -> np.ndarray:
    """``int(s, 16)`` a value, then the JAX package's conversion to uint64:
    a negative value wraps (int64 to uint64); past the int64 and uint64
    ranges it raises."""
    ints = [int(s, 16) for s in values]
    if any(v < -(1 << 63) or v >= (1 << 64) for v in ints):
        raise OverflowError("a hex id is out of the uint64 range")
    return np.array([v % (1 << 64) for v in ints], dtype=np.uint64)


def hashed_ids(ints: np.ndarray, present: np.ndarray, hash_bucket: int) -> np.ndarray:
    """``splitmix64`` of the present ids, hashed into ``[1, hash_bucket)``;
    0 where absent. int32."""
    ids = np.zeros(len(present), np.int64)
    z = splitmix64(ints)
    ids[present] = ((z % np.uint64(hash_bucket - 1)) + np.uint64(1)).astype(np.int64)
    return ids.astype(np.int32)


def parse_sparse(fields: Sequence[str], hash_bucket: int) -> np.ndarray:
    """Hex -> int, ``splitmix64``, hashed into ``[1, hash_bucket)``; missing
    is 0. int32."""
    values = np.asarray(fields, dtype=np.str_)
    present = ~missing_mask(values)
    return hashed_ids(_hex_python(values[present].tolist()), present, hash_bucket)


class RawChunk:
    """One chunk of the raw TSV in bytes: ``u8`` the text, ``starts`` and
    ``ends`` ``[rows, fields]`` each field's byte span. A column is parsed
    in numpy where its fields are plain numbers (decimal integers, hex ids),
    else from its text by the string parsers above."""

    def __init__(self, text: bytes, starts: np.ndarray, ends: np.ndarray):
        self.text, self.starts, self.ends = text, starts, ends
        self.u8 = np.frombuffer(text, np.uint8)

    def strings(self, j: int) -> List[str]:
        return [self.text[s:e].decode() for s, e in zip(self.starts[:, j].tolist(),
                                                         self.ends[:, j].tolist())]

    def bytes_of(self, j: int, width: int):
        """Column j's fields as a ``[rows, w]`` byte matrix (NUL past each
        field's end) and their lengths; None when a field is wider than
        ``width``."""
        lengths = self.ends[:, j] - self.starts[:, j]
        w = int(lengths.max()) if len(lengths) else 0
        if w > width:
            return None
        index = self.starts[:, j, None] + np.arange(w)
        np.minimum(index, len(self.u8) - 1, out=index)
        matrix = self.u8[index]
        matrix[np.arange(w) >= lengths[:, None]] = 0
        return matrix, lengths

    def decimal(self, j: int):
        """Column j as int64 where every field is empty or a decimal integer
        of at most 18 digits with an optional leading minus: (values,
        present); else None."""
        got = self.bytes_of(j, _DECIMAL_WIDTH + 1)
        if got is None:
            return None
        matrix, lengths = got
        if matrix.shape[1] == 0:  # every field empty
            return np.zeros(len(lengths), np.int64), lengths > 0
        negative = matrix[:, 0] == _MINUS
        digits = _DECIMAL_DIGITS[matrix]
        body = matrix != 0
        body[:, 0] &= ~negative
        if (digits[body] == 255).any() or (negative & (lengths < 2)).any() or \
                (lengths - negative > _DECIMAL_WIDTH).any():
            return None
        values = np.zeros(len(lengths), np.int64)
        for column in range(matrix.shape[1]):
            values = np.where(body[:, column], values * 10 + digits[:, column], values)
        return np.where(negative, -values, values), lengths > 0

    def hex(self, j: int):
        """Column j as uint64 where every field is empty or at most 16 hex
        digits: (values of the present fields, present); else None."""
        got = self.bytes_of(j, _HEX_WIDTH)
        if got is None:
            return None
        matrix, lengths = got
        digits = _HEX_DIGITS[matrix]
        body = matrix != 0
        if (digits[body] == 255).any():
            return None
        values = np.zeros(len(lengths), np.uint64)
        for column in range(matrix.shape[1]):
            values = np.where(body[:, column], values * np.uint64(16) + digits[:, column], values)
        present = lengths > 0
        return values[present], present

    def labels(self) -> np.ndarray:
        got = self.decimal(0)
        if got is None:
            return parse_labels(self.strings(0))
        values, present = got
        return np.where(present, values, 0).astype(np.int32)

    def dense(self, j: int) -> np.ndarray:
        got = self.decimal(j)
        if got is None:
            return parse_dense(self.strings(j))
        values, present = got
        return _log1p_clipped(np.where(present, values.astype(np.float64), 0.0))

    def sparse(self, j: int, hash_bucket: int) -> np.ndarray:
        got = self.hex(j)
        if got is None:  # text other than hex digits: missing-value strings, prefixes
            return parse_sparse(self.strings(j), hash_bucket)
        return hashed_ids(*got, hash_bucket)


def prepare_chunk(chunk: RawChunk, hash_bucket: int) -> Frame:
    """One chunk -> the shard columns ``label``, ``d_*``, ``c_*``."""
    out = {C.LABEL: chunk.labels()}
    for i in range(N_DENSE):
        out[f"d_{i}"] = chunk.dense(1 + i)
    for i in range(N_SPARSE):
        out[f"c_{i}"] = chunk.sparse(1 + N_DENSE + i, hash_bucket)
    return out


def _concat(frames: List[Frame]) -> Frame:
    return {name: np.concatenate([f[name] for f in frames]) for name in frames[0]}


def raw_chunk(lines: List[bytes], width: int, first_line: int) -> RawChunk:
    """The lines (line ends stripped) as one ``RawChunk`` of ``width``
    fields a row: a short line is padded with empty (missing) fields; a
    longer line, or a field that opens with a quote, raises."""
    text = b"\n".join(lines) + b"\n"
    if text.startswith(b'"') or b'\t"' in text or b'\n"' in text:
        raise ValueError(f"lines {first_line}-{first_line + len(lines) - 1}: quoted fields are "
                         f"not supported")
    u8 = np.frombuffer(text, np.uint8)
    seps = np.flatnonzero((u8 == _TAB) | (u8 == _NEWLINE))
    ends_of_lines = np.flatnonzero(u8 == _NEWLINE)
    fields = np.diff(np.searchsorted(seps, ends_of_lines, side="right"), prepend=0)
    if (fields > width).any():
        bad = int(np.argmax(fields > width))
        raise ValueError(f"expected {width} fields in line {first_line + bad}, "
                         f"saw {int(fields[bad])}")
    if (fields < width).any():
        lines = [line + b"\t" * (width - k) for line, k in zip(lines, fields.tolist())]
        return raw_chunk(lines, width, first_line)
    ends = seps.reshape(len(lines), width)
    starts = np.empty_like(ends)
    starts[:, 1:] = ends[:, :-1] + 1
    starts[:, 0] = np.concatenate([[0], ends_of_lines[:-1] + 1])
    return RawChunk(text, starts, ends)


def read_raw_chunks(raw_path: str, chunk_rows: int) -> Iterator[RawChunk]:
    """The raw TSV, ``chunk_rows`` non-blank lines a chunk (see the module
    docstring)."""
    with open(raw_path, "rb") as f:
        lines = (line.rstrip(b"\r\n") for line in f)
        lines = (line for line in lines if line)
        width, first_line = None, 1
        while True:
            chunk = list(islice(lines, chunk_rows))
            if not chunk:
                return
            if width is None:
                width = chunk[0].count(b"\t") + 1
                if width < N_FIELDS:
                    raise ValueError(f"{raw_path}: {width} fields in the first line; a Criteo "
                                     f"row has {N_FIELDS}")
            yield raw_chunk(chunk, width, first_line)
            first_line += len(chunk)


def format_criteo(
    dataset_name: str = "Criteo",
    raw_tsv: str = "criteo/train.txt",
    hash_bucket: int = 1_000_000,
    rows_per_shard: int = 1_000_000,
    sample_rows: Optional[int] = None,
    chunk_rows: int = 250_000,
) -> str:
    """Stream ``<raw data dir>/raw_tsv`` into sharded ``.npz`` frames;
    optionally also write the canonical reader frames from the first
    ``sample_rows`` rows. Returns the dataset's directory."""
    raw_path = os.path.join(C.raw_data_dir(), raw_tsv)
    out_dir = os.path.join(C.dataset_dir(), dataset_name)
    shard_dir = os.path.join(out_dir, "shards")
    os.makedirs(shard_dir, exist_ok=True)

    shard_index = 0
    buffered: List[Frame] = []
    buffered_rows = 0
    total = 0
    sample_frames: List[Frame] = []

    def flush():
        nonlocal shard_index, buffered, buffered_rows
        if not buffered:
            return
        write_frame(os.path.join(shard_dir, f"part-{shard_index:05d}.npz"), _concat(buffered))
        shard_index += 1
        buffered, buffered_rows = [], 0

    for chunk in read_raw_chunks(raw_path, chunk_rows):
        prepared = prepare_chunk(chunk, hash_bucket)
        n = frame_rows(prepared)
        if sample_rows and total < sample_rows:
            sample_frames.append({k: v[:sample_rows - total] for k, v in prepared.items()})
        total += n
        buffered.append(prepared)
        buffered_rows += n
        if buffered_rows >= rows_per_shard:
            flush()
    flush()
    logger.info("criteo: %d rows -> %d shards", total, shard_index)

    description = DatasetDescription(
        info=f"Criteo click log ({total} rows, hash bucket {hash_bucket})",
        base_features=[FeatureMeta(C.LABEL, C.CATEGORICAL_COLUMN)],
        context_features=(
            [FeatureMeta(f"d_{i}", C.NUMERIC_COLUMN) for i in range(N_DENSE)]
            + [FeatureMeta(f"c_{i}", C.CATEGORICAL_COLUMN, {"vocab": hash_bucket})
               for i in range(N_SPARSE)]
        ),
    )
    description.save(dataset_name)

    if sample_rows:
        _write_sample(out_dir, {k: v[:sample_rows] for k, v in _concat(sample_frames).items()})
    return out_dir


def _write_sample(out_dir: str, frame: Frame) -> None:
    """The canonical reader frames over the sample rows, with the JAX
    package's skeleton columns (``generate_synthetic_ctr``'s recipe): uid
    drawn from ``default_rng(0)``, iid = ``c_0 + 1``, rate = label, time =
    row, rows in (uid, time) order."""
    rng = np.random.default_rng(0)
    n = frame_rows(frame)
    frame = dict(frame)
    frame[C.UID] = rng.integers(1, max(2, n // 50) + 1, size=n).astype(np.int32)
    frame[C.IID] = frame["c_0"].astype(np.int32) + 1
    frame[C.RATE] = frame[C.LABEL].astype(np.int32)
    frame[C.TIME] = np.arange(n, dtype=np.int32)
    order = np.lexsort((frame[C.TIME], frame[C.UID]))
    frame = {name: values[order] for name, values in frame.items()}
    base = [C.UID, C.IID, C.RATE, C.LABEL, C.TIME]
    write_frame(os.path.join(out_dir, C.BASE_INTERACTION_FRAME), {c: frame[c] for c in base})
    write_frame(os.path.join(out_dir, C.INTERACTION_FRAME), frame)
    write_frame(os.path.join(out_dir, C.ITEM_FRAME),
                {C.IID: np.arange(1, int(frame[C.IID].max()) + 1, dtype=np.int32)})
