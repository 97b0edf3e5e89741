"""The harness tasks' result table without pandas: the tab-separated file
that ``pandas.DataFrame(columns).to_csv(path, sep="\\t")`` writes (the JAX
package's ``RepeatTask`` and ``GridSearch`` write theirs so), and the
columns as the port's numpy frame (``data/process/io.py``).

The file: a header of an empty cell (the unnamed index) and the column
names; then a row a run, its index (0, 1, ...) first. A column of ints is
written as ints, one of bools as ``True``/``False``, one of numbers with a
float among them as floats (Python's shortest round-trip form, ``1.0`` for
an int among floats, an empty cell for NaN), any other column as text;
cells holding the separator, a quote or a line break are quoted, quotes
doubled.
"""

from __future__ import annotations

import csv
import math
import numbers
import os
from typing import Any, Dict, List

import numpy as np

from pytorchrec_tpu_torch.data.process.io import Frame


def _column_cells(values: List[Any]) -> List[str]:
    if all(isinstance(v, (bool, np.bool_)) for v in values):
        return [str(bool(v)) for v in values]
    if all(isinstance(v, numbers.Integral) and not isinstance(v, (bool, np.bool_))
           for v in values):
        return [str(int(v)) for v in values]
    if all(isinstance(v, numbers.Real) and not isinstance(v, (bool, np.bool_)) for v in values):
        return ["" if math.isnan(float(v)) else repr(float(v)) for v in values]
    return ["" if v is None else str(v) for v in values]


def write_results(path: str, columns: Dict[str, List[Any]]) -> Frame:
    """Write ``columns`` (name -> one value a run) to ``path`` as above;
    return them as a frame."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = list(columns)
    cells = [_column_cells(list(columns[name])) for name in names]
    rows = len(cells[0]) if cells else 0
    with open(path, "w", newline="") as out:
        writer = csv.writer(out, delimiter="\t", lineterminator="\n",
                            quoting=csv.QUOTE_MINIMAL)
        writer.writerow(["", *names])
        for i in range(rows):
            writer.writerow([str(i), *(column[i] for column in cells)])
    return {name: np.asarray(list(columns[name])) for name in names}
