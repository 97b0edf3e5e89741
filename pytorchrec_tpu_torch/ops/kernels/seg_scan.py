"""Segmented inclusive sum scan: CUDA kernel, plain version and wrapper.

Replaces ``pytorchrec_tpu/ops/kernels/seg_scan.py::_seg_scan_kernel`` (the
``pl.pallas_call`` of ``segmented_sum_scan_pallas``). For ``x [n, E]`` f32
rows in id-sorted order and ``is_start [n]`` bool marking segment heads it
returns the running sum of each segment, ``[n, E]`` contiguous; each
segment's last row holds its total. The packed sparse update
(``ops/sparse_update.py``) sums duplicate ids' row grads with it.

The kernel (``csrc/seg_scan.cu``) is one pass with a look-back: each block
takes a tile from an atomic ticket, scans it in shared memory, publishes its
aggregate and whether it holds a head, and adds its predecessors'
aggregates, nearest first, down to the nearest tile that holds a head; it
reads and writes each row once (the TPU kernel's grid runs in order and
carries in VMEM; Hopper's blocks do not). The order of every sum is fixed
by the heads, so a call's bits repeat from run to run. It is bound by bytes: reading
``x`` and writing the result, 0.033 ms on the H100 at the update's shape
(n = 851,968, E = 16). ``x`` may be a column slice of wider rows: the kernel
takes the row stride, so the slice is not copied, and loads 4, 2 or 1 floats
at once as the slice's address and stride allow (``scan_vector_width``: the
int8 update's view starts 24 bytes into its rows, so 2). It takes any E:
past 256 columns it launches once for each chunk of 256.

``segmented_sum_scan`` dispatches by device (``ops/kernels/__init__.py``): a
CUDA tensor launches the kernel and raises if the launch fails; a CPU tensor
runs ``segmented_sum_scan_plain``. ``segmented_sum_scan.launches`` counts
calls that launched the kernel (one launch a chunk of 256 columns, after
one memset of the call's ticket and status words).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pytorchrec_tpu_torch.ops.kernels import count_launch, launches_kernel
from pytorchrec_tpu_torch.ops.kernels.build import library


def segmented_sum_scan_plain(x: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the JAX package's full-depth Hillis-Steele
    scan (``pytorchrec_tpu/ops/sparse_update.py::_scan_passes``): shift by
    d, add where no head lies within the last d rows, double d, over
    ceil(log2 n) passes. (A global cumsum minus its value at the heads would
    lose f32 precision over long arrays.)"""
    out = x.to(torch.float32, copy=True)
    done = is_start.to(torch.bool)
    d = 1
    while d < out.shape[0]:
        shifted = torch.cat([out.new_zeros((d, out.shape[1])), out[:-d]])
        shifted_done = torch.cat([done.new_ones(d), done[:-d]])
        out = out + torch.where(done[:, None], 0.0, shifted)
        done = done | shifted_done
        d *= 2
    return out.contiguous()


def scan_vector_width(address: int, row_stride: int, e: int) -> int:
    """Floats a load and a store of B2 (4, 2 or 1): the widest that the first
    row's address (bytes), the row stride (floats) and the row width allow.
    Plain Python: the tests check it on the CPU. The f32 update's slice (64
    floats a row, 192 bytes in) takes 4; the int8 update's (32 floats a row,
    24 bytes in) takes 2; the linear table's E=1 takes 1."""
    for vec in (4, 2):
        if address % (4 * vec) == 0 and row_stride % vec == 0 and e % vec == 0:
            return vec
    return 1


@functools.cache
def _kernel():
    lib = library("seg_scan")
    lib.segmented_sum_scan_f32.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.segmented_sum_scan_f32.restype = ctypes.c_int
    lib.seg_scan_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.seg_scan_scratch_words.restype = ctypes.c_longlong
    lib.seg_scan_kernel_attributes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                               ctypes.POINTER(ctypes.c_int)]
    lib.seg_scan_kernel_attributes.restype = ctypes.c_int
    lib.seg_scan_chunk_width.argtypes = []
    lib.seg_scan_chunk_width.restype = ctypes.c_int
    lib.seg_scan_tile_rows.argtypes = [ctypes.c_int]
    lib.seg_scan_tile_rows.restype = ctypes.c_int
    lib.seg_scan_error_string.argtypes = [ctypes.c_int]
    lib.seg_scan_error_string.restype = ctypes.c_char_p
    return lib


def seg_scan_launch_info(x: torch.Tensor) -> dict:
    """B2's launch over ``x`` on the current card: floats a load, tiles and
    rows a tile of the first chunk, launches (one a chunk), the status words'
    bytes, and the registers and local memory (stack and spills) a thread."""
    n, e = x.shape
    lib = _kernel()
    vec = scan_vector_width(x.data_ptr(), x.stride(0) if n > 1 else e, e)
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.seg_scan_kernel_attributes(vec, ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError("segmented_sum_scan kernel attributes: "
                           + lib.seg_scan_error_string(err).decode())
    chunk = lib.seg_scan_chunk_width()
    rows = lib.seg_scan_tile_rows(min(e, chunk))
    return {"vec": vec, "tile_rows": rows, "tiles": -(-n // rows), "launches": -(-e // chunk),
            "status_bytes": 8 * int(lib.seg_scan_scratch_words(n, e)),
            "registers": regs.value, "local_bytes": local.value}


def _check(x: torch.Tensor, is_start: torch.Tensor) -> None:
    if x.dim() != 2 or is_start.dim() != 1 or is_start.shape[0] != x.shape[0]:
        raise ValueError(f"want x [n, E] and is_start [n]; got {tuple(x.shape)}, "
                         f"{tuple(is_start.shape)}")
    if is_start.dtype != torch.bool:
        raise TypeError(f"is_start must be bool, got {is_start.dtype}")


def _launch(x: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    n, e = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"segmented_sum_scan kernel takes float32 x, got {x.dtype}")
    if x.device != is_start.device:
        raise ValueError(f"is_start is on {is_start.device}, x on {x.device}")
    if n > 1 and (x.stride(1) != 1 or x.stride(0) < e):
        raise ValueError(f"segmented_sum_scan kernel takes rows of E contiguous floats; "
                         f"x has strides {x.stride()}")
    if x.data_ptr() % 4:
        raise ValueError("segmented_sum_scan kernel takes 4-byte aligned rows")
    if not is_start.is_contiguous():
        raise ValueError("segmented_sum_scan kernel takes a contiguous is_start")
    if n >= 2**31:
        raise ValueError(f"n={n} exceeds the kernel's int32 row count")
    lib = _kernel()
    out = torch.empty((n, e), dtype=torch.float32, device=x.device)
    if n == 0 or e == 0:
        return out
    ld = x.stride(0) if n > 1 else e
    vec = scan_vector_width(x.data_ptr(), ld, e)
    # a ticket and the tiles' status words for each chunk, zeroed by the call
    scratch = torch.empty((lib.seg_scan_scratch_words(n, e),), dtype=torch.int64,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.segmented_sum_scan_f32(x.data_ptr(), ld, is_start.data_ptr(), out.data_ptr(),
                                         n, e, vec, scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("segmented_sum_scan kernel launch failed: "
                           + lib.seg_scan_error_string(err).decode())
    count_launch(segmented_sum_scan)
    return out


def segmented_sum_scan(x: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum: ``x [n, E]`` f32 (rows may be strided),
    ``is_start [n]`` bool -> ``[n, E]`` f32, contiguous."""
    _check(x, is_start)
    if launches_kernel(x, is_start):
        return _launch(x, is_start)
    return segmented_sum_scan_plain(x, is_start)


segmented_sum_scan.launches = 0
