"""The port's on-disk tables and the shared IO of the processing pipeline
(port of ``pytorchrec_tpu/data/process/io.py``).

The JAX package keeps its tables as Arrow feather files read through
pandas. The port keeps them as numpy frames, which need neither pandas nor
pyarrow: one uncompressed ``.npz`` file a table (``write_frame``), one
array a column, and a ``__columns__`` array of the names in their order.
``read_frame`` gives the columns back in that order, with their dtypes:
the order is part of the result, since it decides the order of a reader's
``feature_column_dict`` and so of a model's fields.

Every other artifact (split indices ``.npy`` and their ``.csv`` twins,
negatives, histories, the positive-set pickle, the description) keeps the
JAX package's name and bytes. ``frames_from_feather`` converts a dataset
written by the JAX package into frames where pyarrow is installed; it is
the only code of the port that reads feather.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, List, Mapping

import numpy as np

from pytorchrec_tpu_torch.utils import constants as C

Frame = Dict[str, np.ndarray]
COLUMNS_KEY = "__columns__"
# the JAX package's feather tables and the port's frames, by table
FEATHER_FRAMES = ((C.BASE_INTERACTION_FEATHER, C.BASE_INTERACTION_FRAME),
                  (C.INTERACTION_FEATHER, C.INTERACTION_FRAME),
                  (C.ITEM_FEATHER, C.ITEM_FRAME),
                  (C.USER_FEATHER, C.USER_FRAME))


def write_frame(path: str, columns: Mapping[str, np.ndarray]) -> None:
    """One ``.npz`` frame at ``path`` (written whole, then moved into place):
    each column an array of its own dtype, all of one length, and the names
    in order. An ``object`` column raises."""
    arrays = [(str(name), np.asarray(values)) for name, values in columns.items()]
    for name, values in arrays:
        if values.dtype == object:
            raise TypeError(f"column {name!r} has dtype object; a frame holds numeric arrays")
        if name == COLUMNS_KEY:
            raise ValueError(f"{COLUMNS_KEY!r} is the frame's own key")
    lengths = {len(values) for _, values in arrays}
    if len(lengths) > 1:
        raise ValueError(f"columns of different lengths: {lengths}")
    names = np.array([name for name, _ in arrays], dtype=np.str_)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        # np.savez's layout (one .npy member an array), written here so that
        # any column name is allowed
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as archive:
            for name, values in [(COLUMNS_KEY, names), *arrays]:
                with archive.open(f"{name}.npy", "w", force_zip64=True) as member:
                    np.lib.format.write_array(member, np.ascontiguousarray(values),
                                              allow_pickle=False)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def read_frame(path: str) -> Frame:
    """The columns of a frame, in their written order."""
    with np.load(path, allow_pickle=False) as archive:
        return {name: archive[name] for name in archive[COLUMNS_KEY].tolist()}


def frame_rows(frame: Mapping[str, np.ndarray]) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def frames_from_feather(dataset_name: str) -> List[str]:
    """Write the frame of each feather table of ``dataset_name`` (as the
    JAX package writes them) beside it: the same columns in the same order,
    dtypes and values. Needs pyarrow; returns the frames' paths."""
    try:
        from pyarrow import ipc
    except ImportError as e:
        raise ImportError("frames_from_feather needs pyarrow to read feather files") from e
    written = []
    for feather_name, frame_name in FEATHER_FRAMES:
        source = dataset_path(dataset_name, feather_name)
        if not os.path.exists(source):
            continue
        with ipc.open_file(source) as feather:  # feather v2 is the Arrow IPC file format
            table = feather.read_all()
        columns = {name: table.column(name).to_numpy() for name in table.column_names}
        write_frame(dataset_path(dataset_name, frame_name), columns)
        written.append(dataset_path(dataset_name, frame_name))
    return written


def dataset_path(dataset_name: str, *parts: str) -> str:
    return os.path.join(C.dataset_dir(), dataset_name, *parts)


def read_interactions(dataset_name: str, with_features: bool = False) -> Frame:
    name = C.INTERACTION_FRAME if with_features else C.BASE_INTERACTION_FRAME
    return read_frame(dataset_path(dataset_name, name))


def read_items(dataset_name: str) -> Frame:
    return read_frame(dataset_path(dataset_name, C.ITEM_FRAME))


def save_index_array(directory: str, npy_name: str, array: np.ndarray) -> None:
    """Write an index artifact as ``.npy`` plus a ``.csv`` twin to read
    (tab-separated ints), as the JAX package writes them."""
    assert array.dtype == np.int32, array.dtype
    os.makedirs(directory, exist_ok=True)
    np.save(os.path.join(directory, npy_name), array)
    assert npy_name.endswith(".npy"), npy_name
    csv_name = npy_name[: -len(".npy")] + ".csv"
    write_tsv(os.path.join(directory, csv_name), array)


def write_tsv(path: str, array: np.ndarray) -> None:
    """``np.savetxt(path, array, delimiter="\\t", fmt="%d")``'s bytes for an
    int32 array of one or two dimensions (a 1-D array a number a line),
    formatted by numpy arithmetic a block of rows at a time: ``savetxt``
    formats a row at a time, and a history array has a row an interaction."""
    table = array[:, None] if array.ndim == 1 else array
    with open(path, "wb") as f:
        for start in range(0, len(table), _TSV_BLOCK_ROWS):
            f.write(_tsv_bytes(table[start:start + _TSV_BLOCK_ROWS]))


_TSV_BLOCK_ROWS = 65536
_TSV_TABLE_SPAN = 1 << 16  # a block whose numbers span less gathers their cells from a table
_POWERS = 10 ** np.arange(9, -1, -1, dtype=np.int64)  # an int32 has at most 10 digits


def _cells(values: np.ndarray):
    """Each number as a 12-byte cell (a sign, 10 digits, a separator) and
    the mask of the bytes that its text keeps (the separator's included)."""
    magnitude = np.abs(values)
    cells = np.empty((len(values), 12), dtype=np.uint8)
    cells[:, 0] = ord("-")
    cells[:, 1:11] = magnitude[:, None] // _POWERS % 10 + ord("0")
    digits = 1 + (magnitude[:, None] >= _POWERS[:-1]).sum(axis=1)
    keep = np.empty(cells.shape, dtype=bool)
    keep[:, 0] = values < 0
    keep[:, 1:11] = np.arange(10) >= (10 - digits)[:, None]
    keep[:, 11] = True
    return cells, keep


def _tsv_bytes(block: np.ndarray) -> bytes:
    """A block of rows as text: each number and a tab, the row's last one a
    newline."""
    columns = block.shape[1]
    values = block.reshape(-1).astype(np.int64)
    if not len(values):
        return b""
    low, high = int(values.min()), int(values.max())
    if high - low < _TSV_TABLE_SPAN:  # ids and lengths: one cell a distinct value, gathered
        cells, keep = _cells(np.arange(low, high + 1, dtype=np.int64))
        cells, keep = cells[values - low], keep[values - low]
    else:
        cells, keep = _cells(values)
    cells[:, 11] = ord("\t")
    cells[columns - 1::columns, 11] = ord("\n")
    return cells[keep].tobytes()
