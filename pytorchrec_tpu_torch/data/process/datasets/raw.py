"""Raw-file tables for the formatters, without pandas: the reading, joins,
sorts and writes that the JAX package's formatters do with pandas, on
numpy frames (``data/process/io.py``: a dict of column arrays in order).

``read_table`` reads and types each column as ``pandas.read_csv`` does
(``data/process/text.py``). The rest keeps pandas' semantics where the formatters rely on them:
``left_merge`` keeps the left rows in order and turns an int column of the
right into float64 where a key is missing; ``stable_sort`` is a mergesort
over several keys; ``drop_duplicates_last`` keeps each key's last row;
``map_values`` maps through a dict or a function of Python scalars, and an
unmapped value becomes NaN, as ``Series.map`` does; ``as_int`` refuses NaN
as ``astype`` does. ``write_csv`` writes ``DataFrame.to_csv(index=False,
sep="\\t")``'s bytes.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, Hashable, List, Mapping, Optional, Sequence, Union

import numpy as np

from pytorchrec_tpu_torch.data.process.io import (
    TSV_BLOCK_ROWS,
    Frame,
    frame_rows,
    tsv_bytes,
    write_frame,
)
from pytorchrec_tpu_torch.data.process.text import split_fields, typed_column

Table = Dict[Hashable, np.ndarray]


def read_table(path: str, sep: str, header: bool = False,
               usecols: Optional[Sequence[int]] = None, dtype=None,
               dtypes: Optional[Mapping[int, Any]] = None, encoding: str = "utf-8") -> Table:
    """A delimited text file as columns (``data/process/text.py``): keyed by
    the header's names (``header=True``) or by position, as many as the
    header's or the first line's fields; ``usecols`` (positions) in the
    file's order, a longer line's other fields ignored; ``dtype`` for every
    column, ``dtypes`` by position."""
    with open(path, encoding=encoding, newline="") as f:
        lines = [line for line in (raw.rstrip("\r\n") for raw in f) if line]
    names: Optional[List[str]] = None
    if header:
        names, lines = lines[0].split(sep), lines[1:]
    width = len(names) if names is not None else (len(lines[0].split(sep)) if lines else 0)
    if usecols is not None:
        width = max(width, max(usecols) + 1)
    rows = split_fields(lines, sep, width, 2 if header else 1, cut_longer=usecols is not None)
    fields = list(zip(*rows)) if rows else [()] * width
    keep = sorted(usecols) if usecols is not None else range(width)
    dtypes = dict(dtypes or {})
    return {(names[i] if names is not None else i): typed_column(fields[i], dtypes.get(i, dtype))
            for i in keep}


def renamed(table: Table, names: Sequence[str]) -> Frame:
    """The table's columns, in order, under ``names`` (``df.columns = ...``)."""
    if len(names) != len(table):
        raise ValueError(f"{len(names)} names for {len(table)} columns")
    return dict(zip(names, table.values()))


def take(frame: Frame, index: np.ndarray) -> Frame:
    return {name: values[index] for name, values in frame.items()}


def where(frame: Frame, mask: np.ndarray) -> Frame:
    return take(frame, np.flatnonzero(mask))


def stable_sort(frame: Frame, keys: Sequence[str]) -> Frame:
    """``sort_values(by=keys, kind="mergesort")``: ties keep their order."""
    return take(frame, np.lexsort([frame[k] for k in reversed(keys)]))


def drop_duplicates_last(frame: Frame, keys: Sequence[str]) -> Frame:
    """``drop_duplicates(keys, keep="last")``: each key's last row, rows in
    their order."""
    stacked = np.stack([np.asarray(frame[k]) for k in keys], axis=1)[::-1]
    _, first_of_reversed = np.unique(stacked, axis=0, return_index=True)
    keep = np.sort(frame_rows(frame) - 1 - first_of_reversed)
    return take(frame, keep)


def map_values(values: np.ndarray, mapping: Union[Mapping, Callable]) -> np.ndarray:
    """``Series.map``: each value (a Python scalar) through a dict (NaN where
    a value is absent) or a function; the result typed as pandas infers it
    (int64, float64, or object)."""
    items = np.asarray(values).tolist()
    if callable(mapping):
        out = [mapping(v) for v in items]
    else:
        out = [mapping.get(v, np.nan) if not _is_nan(v) else np.nan for v in items]
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in out):
        return np.array(out, dtype=np.int64)
    if all(isinstance(v, (int, float, np.integer, np.floating)) for v in out):
        return np.array(out, dtype=np.float64)
    return np.array(out, dtype=object)


def _is_nan(value) -> bool:
    return isinstance(value, float) and math.isnan(value)


def as_int(values: np.ndarray, dtype) -> np.ndarray:
    """``astype(dtype)`` for an integer ``dtype``: NaN raises, as pandas
    refuses to cast a missing value to an integer."""
    values = np.asarray(values)
    if values.dtype == object:
        if any(_is_nan(v) for v in values.tolist()):
            raise ValueError("cannot convert a missing value (NaN) to an integer")
        return np.array(values.tolist()).astype(dtype)
    if values.dtype.kind == "f" and np.isnan(values).any():
        raise ValueError("cannot convert a missing value (NaN) to an integer")
    return values.astype(dtype)


def left_merge(left: Frame, right: Frame, key: str) -> Frame:
    """``left.merge(right, on=key, how="left")`` for a right side with
    unique keys: the left rows in order, then the right's other columns; a
    right int column becomes float64 where a key is missing (NaN)."""
    keys = np.asarray(right[key])
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    if len(sorted_keys) > 1 and (sorted_keys[1:] == sorted_keys[:-1]).any():
        raise ValueError(f"left_merge needs unique keys on the right; {key!r} repeats")
    probe = np.asarray(left[key])
    pos = np.minimum(np.searchsorted(sorted_keys, probe), max(len(sorted_keys) - 1, 0))
    found = (sorted_keys[pos] == probe) if len(sorted_keys) else np.zeros(len(probe), bool)
    rows = order[pos] if len(sorted_keys) else pos
    out = dict(left)
    for name, values in right.items():
        if name == key:
            continue
        if name in out:
            raise ValueError(f"column {name!r} is on both sides of the merge")
        column = np.asarray(values)[rows]
        if not found.all():
            if column.dtype.kind in "iub":
                column = column.astype(np.float64)
            elif column.dtype.kind != "f":
                column = column.astype(object)
            column[~found] = np.nan
        out[name] = column
    return out


def _text_column(values: np.ndarray) -> List[str]:
    """One column as ``to_csv`` writes it: numbers in numpy's ``str``, NaN
    as an empty field."""
    if values.dtype.kind == "f":
        text = values.astype(str)
        text[np.isnan(values)] = ""
        return text.tolist()
    return [str(v) for v in values.tolist()]


def write_csv(path: str, frame: Frame) -> None:
    """``DataFrame.to_csv(path, index=False, sep="\t")``'s bytes: a header
    line, then a line a row. Integer frames are formatted by numpy
    arithmetic a block of rows at a time (``io.py::tsv_bytes``)."""
    columns = [np.asarray(v) for v in frame.values()]
    with open(path, "wb") as f:
        f.write(("\t".join(frame) + "\n").encode())
        if all(c.dtype.kind in "iu" for c in columns) and all(
                len(c) == 0 or int(np.abs(c.astype(np.int64)).max()) < 10 ** 10
                for c in columns):
            for start in range(0, frame_rows(frame), TSV_BLOCK_ROWS):
                f.write(tsv_bytes(np.stack([c[start:start + TSV_BLOCK_ROWS].astype(np.int64)
                                            for c in columns], axis=1)))
            return
        texts = [_text_column(c) for c in columns]
        f.write("".join("\t".join(row) + "\n" for row in zip(*texts)).encode())


def write_table(out_dir: str, csv_name: str, frame_name: str, frame: Frame) -> None:
    """A table's ``.csv`` (pandas' bytes) and its ``.npz`` frame."""
    write_csv(os.path.join(out_dir, csv_name), frame)
    write_frame(os.path.join(out_dir, frame_name), frame)
