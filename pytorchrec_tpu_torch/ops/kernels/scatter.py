"""Row scatter-set in place: CUDA kernel, plain version and wrapper.

Replaces ``pytorchrec_tpu/ops/kernels/dma_scatter.py::_scatter_kernel`` (the
``pl.pallas_call`` of ``dma_scatter_set``), which computes
``table.at[ids].set(rows, mode='drop', unique_indices=True)``: for each slot
``i`` with ``0 <= ids[i] < V`` it sets ``table[ids[i]] = rows[i]``; other
slots are dropped. The ids that survive must be unique. The JAX function
returns a new table under donation; the port writes into ``table`` itself.

The kernel (``csrc/scatter.cu``) copies each surviving row with 16 threads,
16 bytes a thread; a dropped slot costs its id read. It is bound by bytes:
0.112 ms on the H100 at the packed update's shape (852k slots, about 726k
surviving 256-byte rows into a ``[2.6M, 64]`` f32 table).

``scatter_set_rows`` dispatches by device (``ops/kernels/__init__.py``): a
CUDA tensor launches the kernel and raises if the launch fails; a CPU tensor
runs ``scatter_set_rows_plain``. ``scatter_set_rows.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pytorchrec_tpu_torch.ops.kernels import count_launch, launches_kernel
from pytorchrec_tpu_torch.ops.kernels.build import library


def scatter_set_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                           ids: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_copy_`` of the surviving rows."""
    keep = (ids >= 0) & (ids < table.shape[0])
    return table.index_copy_(0, ids[keep].to(torch.int64), rows[keep])


@functools.cache
def _kernel():
    lib = library("scatter")
    lib.scatter_set_rows_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    lib.scatter_set_rows_launch.restype = ctypes.c_int
    lib.scatter_error_string.argtypes = [ctypes.c_int]
    lib.scatter_error_string.restype = ctypes.c_char_p
    return lib


def _check(table: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or rows.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"want table [V, W], rows [n, W], ids [n]; got {tuple(table.shape)}, "
                         f"{tuple(rows.shape)}, {tuple(ids.shape)}")
    if rows.shape[1] != table.shape[1] or rows.shape[0] != ids.shape[0]:
        raise ValueError(f"rows {tuple(rows.shape)} do not fit table {tuple(table.shape)} "
                         f"and ids {tuple(ids.shape)}")
    if rows.dtype != table.dtype:
        raise TypeError(f"rows are {rows.dtype}, the table {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")


def _launch(table: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    for name, t in (("table", table), ("rows", rows), ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"scatter_set_rows kernel takes contiguous tensors; {name} is not")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, the table on {table.device}")
    if table.shape[0] >= 2**31:
        raise ValueError(f"a table of {table.shape[0]} rows exceeds the kernel's int32 ids")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes == 0:
        return table
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel().scatter_set_rows_launch(table.data_ptr(), rows.data_ptr(), ids.data_ptr(),
                                                ids.shape[0], table.shape[0], row_bytes, stream)
    if err != 0:
        raise RuntimeError("scatter_set_rows kernel launch failed: "
                           + _kernel().scatter_error_string(err).decode())
    count_launch(scatter_set_rows)
    return table


def scatter_set_rows(table: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids[i]] = rows[i]`` in place for ``0 <= ids[i] < V``; other
    slots drop. Surviving ids must be unique. Returns ``table``."""
    _check(table, rows, ids)
    if launches_kernel(table, rows, ids):
        return _launch(table, rows, ids)
    return scatter_set_rows_plain(table, rows, ids)


scatter_set_rows.launches = 0
