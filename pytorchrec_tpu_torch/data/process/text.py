"""Delimited text as ``pandas.read_csv`` reads it, without pandas: the
streaming source's ``.csv``/``.tsv`` shards, ``format_criteo``'s raw TSV and
the other raw formatters' files.

* ``text_lines``: the non-blank lines, a chunk of them at a time (pandas
  skips blank lines);
* ``split_fields``: a line's fields, a short line padded with missing
  fields; a longer line raises, as pandas' does unless it reads only some
  columns; a quoted field raises (pandas' C parser unquotes it, which is
  not ported);
* ``missing_mask``: pandas' default missing-value strings (``NA_STRINGS``);
* ``typed_column``: a column typed as pandas types it: int64 where every
  value is an integer, float64 where one is fractional or missing (NaN),
  else text (an object array of ``str``, NaN where missing).
"""

from __future__ import annotations

from itertools import islice
from typing import Iterator, List, Sequence

import numpy as np

# pandas' default missing-value strings (read_csv's keep_default_na)
NA_STRINGS = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                        "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                        "nan", "null"))


def text_lines(f, chunk_rows: int) -> Iterator[List[str]]:
    """The non-blank lines of the text file ``f`` (line ends stripped),
    ``chunk_rows`` at a time."""
    lines = (line.rstrip("\r\n") for line in f)
    lines = (line for line in lines if line)
    while True:
        chunk = list(islice(lines, chunk_rows))
        if not chunk:
            return
        yield chunk


def split_fields(lines: List[str], sep: str, width: int, first_line: int,
                 cut_longer: bool = False) -> List[List[str]]:
    """Each line's fields, a short line padded with empty (missing) fields to
    ``width``; a line with more fields raises, or is cut to ``width`` with
    ``cut_longer`` (pandas reading only some columns, ``usecols``). A field
    that opens with a quote raises where ``sep`` is one character (pandas'
    C parser unquotes it); a quote elsewhere, or under a longer ``sep``
    (pandas' python engine), is text. ``first_line`` numbers the lines in
    the errors."""
    rows = []
    for i, line in enumerate(lines):
        fields = line.split(sep)
        if len(sep) == 1 and '"' in line and any(f.startswith('"') for f in fields):
            raise ValueError(f"line {first_line + i}: quoted fields are not supported")
        if len(fields) > width:
            if not cut_longer:
                raise ValueError(f"expected {width} fields in line {first_line + i}, "
                                 f"saw {len(fields)}")
            fields = fields[:width]
        elif len(fields) < width:
            fields += [""] * (width - len(fields))
        rows.append(fields)
    return rows


def missing_mask(values: np.ndarray) -> np.ndarray:
    """Where a string array holds one of pandas' missing-value strings."""
    return np.isin(values, list(NA_STRINGS))


def typed_column(strings: Sequence[str], dtype=None) -> np.ndarray:
    """One column of text as pandas types it (see the module docstring), or
    as ``dtype``: ``str`` keeps the text, a numpy integer type parses it
    (a missing value raises)."""
    values = np.asarray(strings, dtype=np.str_)
    missing = missing_mask(values)
    if dtype is not None and dtype is not str:
        if missing.any():
            raise ValueError("a missing value cannot be read as an integer")
        return values.astype(dtype)
    if dtype is None:
        if not missing.any():
            try:
                return values.astype(np.int64)
            except (ValueError, OverflowError):
                pass
        try:
            out = np.full(len(values), np.nan)
            out[~missing] = values[~missing].astype(np.float64)
            return out
        except ValueError:
            pass
    out = np.array(list(strings), dtype=object)
    out[missing] = np.nan
    return out
