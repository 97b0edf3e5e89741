"""Row scatter-set in place: CUDA kernel, plain version and wrapper.

Replaces ``pytorchrec_tpu/ops/kernels/dma_scatter.py::_scatter_kernel`` (the
``pl.pallas_call`` of ``dma_scatter_set``), which computes
``table.at[ids].set(rows, mode='drop', unique_indices=True)``: for each slot
``i`` with ``0 <= ids[i] < V`` it sets ``table[ids[i]] = rows[i]``; other
slots are dropped. The ids that survive must be unique. The JAX function
returns a new table under donation; the port writes into ``table`` itself.

The kernel (``csrc/scatter.cu``) copies each surviving row with a group of
lanes sized to the row (``scatter_plan``): the widest unit of 16, 8, 4, 2
or 1 bytes that divides the row and both base addresses, and as many lanes
as divide its units, up to 32, so that no lane idles: one thread a row at 4
and 16 bytes (the classic update's scales and int8 rows, the rowwise
accumulators), 4 lanes at 64 bytes (per-field f32 tables), 16 at 256 bytes
(the packed f32 update). A group copies up to 4 rows, its ids loaded once
and shuffled to its lanes, every load in flight before the first store.

What bounds it. Wide rows are bound by their bytes: 0.112 ms on the H100 at
the packed update's shape (852k slots, about 726k surviving 256-byte rows
into a ``[2.6M, 64]`` f32 table). Narrow rows are bound by sectors: each
row written lands in a 32-byte sector of its own, so a 4-byte row costs a
sector write where the bytes' bound counts 4 bytes; their 10–42 MB tables
fit in the 50 MB L2, so the writes stay in L2 and the id reads, the sectors
and the launch set the pace. The ids are sorted at every call site, so the
one-thread-a-row plan gives a warp's stores neighbouring rows.

``scatter_set_rows`` dispatches by device (``ops/kernels/__init__.py``): a
CUDA tensor launches the kernel and raises if the launch fails; a CPU tensor
runs ``scatter_set_rows_plain``. ``scatter_set_rows.launches`` counts kernel
launches; a call of no slots launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pytorchrec_tpu_torch.ops.kernels import count_launch, launches_kernel
from pytorchrec_tpu_torch.ops.kernels.build import library

THREADS = 256  # a block (csrc/scatter.cu)
UNITS = (16, 8, 4, 2, 1)  # bytes a load and a store, widest first
MAX_LANES = 32
MAX_LANE_UNITS = 4  # units a lane holds in registers; past it a lane loops


class ScatterPlan(NamedTuple):
    """How the kernel copies rows of one width (``scatter_plan``)."""

    unit: int         # bytes a load and a store
    units: int        # units a row
    lanes: int        # threads that copy one row, a power of two up to 32
    lane_units: int   # units a lane copies: ceil(units / lanes)
    group_rows: int   # rows a lane group copies
    groups: int       # lane groups a block: lanes * groups = THREADS
    block_slots: int  # slots a block covers: groups * group_rows


def scatter_plan(row_bytes: int, address_alignment: int) -> ScatterPlan:
    """The kernel's plan for rows of ``row_bytes`` bytes whose base addresses
    are both multiples of every unit that divides ``address_alignment``
    (``table.data_ptr() | rows.data_ptr()``). Plain Python: the tests check
    it on the CPU, and ``csrc/scatter.cu`` checks that a plan it is given
    fits the row and the addresses.

    * unit: the widest of 16, 8, 4, 2 and 1 that divides the row and the
      addresses;
    * lanes: the largest power of two up to 32 that divides the units, so
      no lane idles (192 B: 4 lanes of 3 units; 384 B: 8 of 3; 1 KB: 32 of
      2; 4 and 16 B: one thread a row). Where that leaves a lane more than
      ``MAX_LANE_UNITS`` units below 32 lanes (an odd factor above 4: 13 f32
      columns, 7 bytes), the fewest lanes that hold at most that many each,
      and the last pass leaves some idle;
    * rows a group: 4 where a lane copies one unit, 2 where up to
      ``MAX_LANE_UNITS``, 1 beyond (the kernel loops there).
    """
    if row_bytes < 1:
        raise ValueError(f"no plan for rows of {row_bytes} bytes")
    unit = next(u for u in UNITS if row_bytes % u == 0 and address_alignment % u == 0)
    units = row_bytes // unit
    lanes = min(units & -units, MAX_LANES)
    if -(-units // lanes) > MAX_LANE_UNITS and lanes < MAX_LANES:
        lanes = min(MAX_LANES, 1 << (-(-units // MAX_LANE_UNITS) - 1).bit_length())
    lane_units = -(-units // lanes)
    group_rows = 4 if lane_units == 1 else 2 if lane_units <= MAX_LANE_UNITS else 1
    groups = THREADS // lanes
    return ScatterPlan(unit, units, lanes, lane_units, group_rows, groups, groups * group_rows)


def scatter_set_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                           ids: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_copy_`` of the surviving rows."""
    keep = (ids >= 0) & (ids < table.shape[0])
    return table.index_copy_(0, ids[keep].to(torch.int64), rows[keep])


@functools.cache
def _kernel():
    lib = library("scatter")
    lib.scatter_set_rows_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                                            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.scatter_set_rows_launch.restype = ctypes.c_int
    lib.scatter_kernel_attributes.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.scatter_kernel_attributes.restype = ctypes.c_int
    lib.scatter_error_string.argtypes = [ctypes.c_int]
    lib.scatter_error_string.restype = ctypes.c_char_p
    return lib


def scatter_launch_info(table: torch.Tensor, rows: torch.Tensor, n: int) -> dict:
    """The kernel's launch for ``n`` slots of ``rows`` into ``table`` on the
    current card: the plan, the grid, and the registers and local memory
    (stack and spills) a thread."""
    plan = scatter_plan(table.shape[1] * table.element_size(), table.data_ptr() | rows.data_ptr())
    regs, local = ctypes.c_int(), ctypes.c_int()
    lib = _kernel()
    err = lib.scatter_kernel_attributes(plan.unit, plan.lanes, plan.lane_units,
                                        ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError("scatter_set_rows kernel attributes: "
                           + lib.scatter_error_string(err).decode())
    return {**plan._asdict(), "blocks": -(-n // plan.block_slots), "registers": regs.value,
            "local_bytes": local.value}


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
    if row_bytes == 0 or ids.shape[0] == 0:
        return table
    plan = scatter_plan(row_bytes, table.data_ptr() | rows.data_ptr())
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel().scatter_set_rows_launch(
            table.data_ptr(), rows.data_ptr(), ids.data_ptr(), ids.shape[0], table.shape[0],
            row_bytes, plan.unit, plan.lanes, plan.lane_units, plan.group_rows, stream)
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
