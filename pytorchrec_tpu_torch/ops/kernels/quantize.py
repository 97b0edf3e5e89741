"""Row quantization, f32 rows <-> int8 (or nibble-packed int4) + f32 scale,
the classic table update's stochastic quantize kernel and the packed int8
table update's requantize kernel (port of
``pytorchrec_tpu/ops/kernels/quantize.py``).

Plain torch: int4 packing, quantization with round-to-nearest (table init)
or stochastic rounding from given bits (``quantize_rows``, every format),
dequantization, the id-keyed rounding bits and the per-step salt they take.

Kernel B8. ``stochastic_quantize_rows`` replaces ``_quantize_kernel`` (the
``pl.pallas_call`` of ``quantize_rows_pallas``): f32 rows give int8 rows and
one scale a row, ``quantize_rows(rows, bits, bits=8, col_groups=1)`` bit for
bit, with the rounding bits either given (uint32 held in int32, the TPU
kernel's contract) or keyed by the rows' global ids and a salt, which the
kernel hashes itself (``id_keyed_rounding_bits``, ``csrc/id_hash.cuh``). The
classic quantized-row trainer runs the keyed form once a step on each int8
table (``training/quantized_trainer.py``); round-to-nearest, int4 and column
groups stay plain torch, as no TPU kernel covers them. The kernel
(``csrc/quantize.cu``) gives each row a group of lanes, 4 columns a lane
read once with a 16-byte load where E is a multiple of 4 up to 128
(``quantize_geometry``). It is bound by bytes: keyed, rows and ids read, q
and scale written, 75.0 MB at the classic step's shape (851,968 rows,
E=16), 0.0224 ms on the H100 at 3.35 TB/s.

Kernel B3. ``requantize_rows`` replaces ``_requantize_kernel`` (the
``pl.pallas_call`` of ``requantize_rows_pallas``): over the permuted packed
``q || scale || acc || ...`` byte rows of an int8 table (one scale a row) and
the rows' summed grads it runs the rowwise-Adagrad step and the id-keyed
stochastic requantization and returns the new byte rows. The kernel
(``csrc/requantize.cu``) gives each row a group of lanes, 4 columns a lane
(4 lanes a row, 8 rows a warp at E=16), keeps the updated row in registers
and writes it in 16-byte stores (4-byte ones where the row width is not a
multiple of 16); ``requantize_geometry`` picks the layout. It is bound by
bytes: it reads each row's ``q || scale || acc`` bytes, its grads and its
id, and writes the whole new row, 187 MB at the main path's shape (851,968
rows of 128 bytes, E=16), 0.056 ms on the H100 at 3.35 TB/s.

Both wrappers dispatch by device (``ops/kernels/__init__.py``): a CUDA
tensor launches the kernel and raises if the launch fails; a CPU tensor runs
the plain version (``stochastic_quantize_rows_plain``,
``requantize_rows_plain``). ``<wrapper>.launches`` counts kernel launches.
The JAX package runs its kernel only when an environment variable
asks for it, because it measured slower there than XLA's chain on its TPU;
the port runs it on every int8 step on the card.

Unsigned 32-bit arithmetic: torch has no full uint32 arithmetic, so hashes
run in int64 holding values in ``[0, 2**32)`` and every product is split
into 16-bit halves, so no intermediate leaves int64.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import numbers
import zlib
from typing import Optional, Tuple, Union

import torch

from pytorchrec_tpu_torch.ops.kernels import count_launch, launches_kernel
from pytorchrec_tpu_torch.ops.kernels.build import library
from pytorchrec_tpu_torch.ops.sparse_update import bytes_to_f32, mean_square_rows
from pytorchrec_tpu_torch.utils.rng import fold_in, random_bits_u32

_U32 = 0xFFFFFFFF


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., E] int8 values in [-7, 7] -> [..., E//2] packed bytes (even
    columns in the low nibble, odd in the high)."""
    v = q.to(torch.int32)
    low = v[..., 0::2] & 0xF
    high = (v[..., 1::2] & 0xF) << 4
    return (low | high).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., E//2] packed bytes -> [..., E] int8 values in [-8, 7]
    (two's-complement nibble sign-extension via the xor-8 trick)."""
    p = packed.to(torch.int32) & 0xFF
    low = ((p & 0xF) ^ 8) - 8
    high = (((p >> 4) & 0xF) ^ 8) - 8
    out = torch.stack([low, high], dim=-1)
    return out.reshape(*packed.shape[:-1], -1).to(torch.int8)


def quantize_rows(rows: torch.Tensor, rng_bits: Optional[torch.Tensor] = None, bits: int = 8,
                  col_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, E] f32 -> ([N, E] int8 (bits=8) or [N, E//2] packed (bits=4),
    f32 scale [N] or [N, G]).

    ``rng_bits`` (``[N, E]`` uint32 values: integers in ``[0, 2**32)``, or
    their int32 bit patterns) selects stochastic
    rounding, ``floor(x + (bits >> 8) * 2**-24)``; without it values round to
    nearest, ties to even, as ``jnp.rint`` does. ``col_groups=G`` gives each
    row G column groups with an absmax scale of their own."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    n, e = rows.shape
    if e % col_groups:
        raise ValueError(f"E={e} does not split into {col_groups} column groups")
    if bits == 4 and (e // col_groups) % 2:
        raise ValueError("int4 groups must pack to whole bytes")
    qmax = 127.0 if bits == 8 else 7.0
    grouped = rows.reshape(n, col_groups, e // col_groups)
    absmax = grouped.abs().amax(dim=-1)                       # [N, G]
    scale = torch.where(absmax > 0, _divide(absmax, qmax), torch.ones_like(absmax))
    scaled = (grouped / scale[..., None]).reshape(n, e)
    if rng_bits is None:
        q = torch.round(scaled)
    else:
        u = ((rng_bits.to(torch.int64) & _U32) >> 8).to(torch.float32) * (1.0 / (1 << 24))
        q = torch.floor(scaled + u)
    q = q.clamp(-qmax, qmax).to(torch.int8)
    if col_groups == 1:
        scale = scale[:, 0]
    if bits == 4:
        return pack_int4(q), scale
    return q, scale


def _divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, correctly rounded on every device: on a CUDA tensor torch
    divides by a host scalar as a product with its reciprocal, which can
    differ in the last bit from the division the JAX package and the kernel
    compute."""
    return x / torch.full_like(x, c)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, bits: int = 8,
                    col_groups: int = 1) -> torch.Tensor:
    """([..., E] int8 or [..., E//2] packed int4, [...] or [..., G] f32)
    -> [..., E] f32. ``col_groups`` must match the quantization call."""
    if bits == 4:
        q = unpack_int4(q)
    if col_groups == 1:
        return q.to(torch.float32) * scale[..., None]
    e = q.shape[-1]
    per_col = torch.repeat_interleave(scale, e // col_groups, dim=-1)  # [..., E]
    return q.to(torch.float32) * per_col


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)`` (int64) and a uint32
    constant, in 16-bit halves so that no product leaves int64."""
    high = ((x >> 16) * c) & 0xFFFF
    return ((high << 16) + (x & 0xFFFF) * c) & _U32


def _mix_u32(x: torch.Tensor) -> torch.Tensor:
    """The triple32-style finalizer of ``id_keyed_rounding_bits``."""
    x = x ^ (x >> 17)
    x = _mul_u32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul_u32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x31848BAB)
    return x ^ (x >> 14)


def id_keyed_rounding_bits(ids: torch.Tensor, e: int,
                           salt: Union[int, torch.Tensor]) -> torch.Tensor:
    """Stochastic-rounding bits keyed by (row id, column, salt): ``ids [n]``
    integers (taken mod 2**32), ``salt`` a uint32, or its device word (a
    one-element int32 tensor holding its bits, ``salt_word``, which a CUDA
    graph reads at replay) -> ``[n, e]`` int64 values in ``[0, 2**32)``.
    They depend on the global row id, never on the slot or the device, so
    every layout rounds a row alike."""
    idv = ids.to(torch.int64) & _U32
    cols = torch.arange(e, dtype=torch.int64, device=ids.device)
    x = (_mul_u32(idv, 0x9E3779B1)[:, None] + _mul_u32(cols, 0x85EBCA77)[None, :]) & _U32
    if isinstance(salt, torch.Tensor):
        return _mix_u32(x ^ (salt.reshape(1, 1).to(torch.int64) & _U32))
    return _mix_u32(x ^ (int(salt) & _U32))


def salt_word(salt: Union[int, torch.Tensor], device) -> torch.Tensor:
    """The salt as the kernels read it: one device word, a ``[1]`` int32
    tensor holding the uint32's bits. A tensor (the trainer passes a slot of
    its step scalars) must be one int32 value on ``device`` and is returned
    as it is; an int in ``[0, 2**32)`` is copied to ``device`` (from pinned
    memory, so the copy waits for nothing queued before it)."""
    if isinstance(salt, torch.Tensor):
        if salt.dtype != torch.int32 or salt.numel() != 1:
            raise TypeError(f"a salt tensor is one int32 word; got {salt.dtype} "
                            f"{tuple(salt.shape)}")
        if salt.device != torch.device(device):
            raise ValueError(f"the salt word is on {salt.device}, the rows on {device}")
        return salt.reshape(1)
    if isinstance(salt, bool) or not isinstance(salt, numbers.Integral) or \
            not 0 <= int(salt) <= _U32:
        raise ValueError(f"salt must be an int in [0, 2**32) or its int32 word; got {salt!r}")
    word = torch.tensor([int(salt) - ((int(salt) >> 31) << 32)], dtype=torch.int32)
    if torch.device(device).type == "cuda":  # an asynchronous copy: no wait for the stream
        return word.pin_memory().to(device, non_blocking=True)
    return word


def rounding_bits_i32(bits: torch.Tensor) -> torch.Tensor:
    """Integers in ``[0, 2**32)`` (``id_keyed_rounding_bits``' int64) -> the
    same uint32 bit patterns held in int32: values of ``2**31`` and above wrap
    to negatives (``2**32 - 1`` -> ``-1``), never saturate."""
    x = bits.to(torch.int64) & _U32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def table_rounding_salt(key, step: int, path: str) -> int:
    """The per-(table, step) salt of ``id_keyed_rounding_bits``, from the
    train state's key (numpy ``uint32[2]``, ``utils/rng.py``), the 1-based
    step and the table's flax path: the JAX package's salt, bit for bit."""
    base = random_bits_u32(fold_in(key, zlib.crc32(path.encode()) & 0x7FFFFFFF))
    return base ^ ((int(step) * 0x9E3779B9) & _U32)


def requantize_rows_chain(moved: torch.Tensor, g: torch.Tensor, rng_bits: torch.Tensor,
                          lr: float, e: int, eps: float = 1e-6, bits: int = 8,
                          col_groups: int = 1) -> torch.Tensor:
    """Rowwise Adagrad and stochastic requantization of packed byte rows, any
    format, as the JAX package's chain computes it: ``moved [n, W]`` u8
    ``q || scale || acc || ...`` rows, ``g [n, e]`` f32 summed grads,
    ``rng_bits [n, e]`` -> ``[n, W]`` u8 ``q' || scale' || acc'`` rows, zero
    from the end of ``acc'`` on."""
    n, w = moved.shape
    qb = e if bits == 8 else e // 2
    sb = qb + 4 * col_groups
    scale_old = bytes_to_f32(moved[:, qb:sb])
    acc_old = bytes_to_f32(moved[:, sb:sb + 4])[:, 0]
    current = dequantize_rows(moved[:, :qb].contiguous().view(torch.int8),
                              scale_old[:, 0] if col_groups == 1 else scale_old,
                              bits=bits, col_groups=col_groups)
    acc_new = acc_old + mean_square_rows(g)
    new_rows = current - lr * g / (torch.sqrt(acc_new)[:, None] + eps)
    q_new, s_new = quantize_rows(new_rows, rng_bits=rng_bits, bits=bits, col_groups=col_groups)
    return torch.cat([q_new.view(torch.uint8),
                      s_new.reshape(n, col_groups).view(torch.uint8),
                      acc_new[:, None].view(torch.uint8),
                      moved.new_zeros((n, w - sb - 4))], dim=1)


def requantize_rows_plain(moved: torch.Tensor, g: torch.Tensor, ids: torch.Tensor,
                          salt: Union[int, torch.Tensor], lr: float, e: int,
                          eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the chain at bits=8, one
    scale a row, with the id-keyed bits of ``ids`` and ``salt``."""
    return requantize_rows_chain(moved, g, id_keyed_rounding_bits(ids, e, salt), lr, e, eps)


# csrc/requantize.cu's threads a block, widest row (bytes) and the
# (lanes a row, q words a lane) pairs it is built for: up to 512 q bytes a
# row, held in registers
REQUANTIZE_THREADS = 256
REQUANTIZE_MAX_WIDTH = 4096
REQUANTIZE_INSTANCES = ((4, 1), (8, 1), (16, 1), (32, 1), (32, 4))
REQUANTIZE_MAX_E = 4 * max(g * k for g, k in REQUANTIZE_INSTANCES)


@dataclasses.dataclass(frozen=True)
class RequantizeGeometry:
    """How B3 lays out one call: ``group`` lanes a row (``32 // group`` rows a
    warp), ``words`` q words of 4 columns a lane, held in registers, and
    ``unit`` the bytes a lane stores at once: 16 where the row width is a
    multiple of 16, else 4. The grid is the card's to size (occupancy times
    SMs, ``requantize_grid``)."""

    group: int
    words: int
    unit: int

    @property
    def rows_per_warp(self) -> int:
        return 32 // self.group


def requantize_geometry(w: int, e: int) -> RequantizeGeometry:
    """B3's layout for rows of ``w`` bytes holding ``e`` int8 columns. Plain
    Python: the tests check it on the CPU. A lane computes 4 columns (one q
    word, one float4 of grads), so a row takes its q words' count of lanes,
    rounded up to a power of two and at least 4 (the 16-byte unit's 4 words
    gather within a group); past 32 words (e > 128) 32 lanes hold 4 words
    each, so e is at most REQUANTIZE_MAX_E."""
    if e < 1 or e + 8 > w or w % 4 or w > REQUANTIZE_MAX_WIDTH or e > REQUANTIZE_MAX_E:
        raise ValueError(f"requantize_rows kernel takes rows of a multiple of 4 bytes, at most "
                         f"{REQUANTIZE_MAX_WIDTH}, holding e <= {REQUANTIZE_MAX_E} q bytes, a "
                         f"scale and an accumulator; got W={w}, e={e}")
    q_words = -(-e // 4)
    group = min(32, max(4, 1 << (q_words - 1).bit_length()))
    words = next(k for g, k in REQUANTIZE_INSTANCES if g == group and g * k >= q_words)
    return RequantizeGeometry(group, words, 16 if w % 16 == 0 else 4)


@functools.cache
def _kernel():
    lib = library("requantize")
    lib.requantize_rows_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.requantize_rows_launch.restype = ctypes.c_int
    lib.requantize_grid.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.requantize_grid.restype = ctypes.c_longlong
    lib.requantize_registers.argtypes = [ctypes.c_int] * 3
    lib.requantize_registers.restype = ctypes.c_int
    for name in ("requantize_max_width", "requantize_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.requantize_error_string.argtypes = [ctypes.c_int]
    lib.requantize_error_string.restype = ctypes.c_char_p
    built = (lib.requantize_threads(), lib.requantize_max_width())
    if built != (REQUANTIZE_THREADS, REQUANTIZE_MAX_WIDTH):
        raise RuntimeError(f"csrc/requantize.cu's threads and widest row {built} differ from "
                           f"{(REQUANTIZE_THREADS, REQUANTIZE_MAX_WIDTH)}")
    return lib


def requantize_launch_info(n: int, w: int, e: int) -> dict:
    """B3's launch at ``n`` rows of ``w`` bytes and ``e`` columns on the
    current card: the geometry, the grid and the registers a thread."""
    geometry = requantize_geometry(w, e)
    lib = _kernel()
    args = (geometry.group, geometry.words, geometry.unit)
    return {"group": geometry.group, "rows_per_warp": geometry.rows_per_warp,
            "words": geometry.words, "unit": geometry.unit,
            "grid": int(lib.requantize_grid(n, *args)),
            "registers": int(lib.requantize_registers(*args))}


def _check(moved: torch.Tensor, g: torch.Tensor, ids: torch.Tensor, e: int) -> None:
    if moved.dim() != 2 or tuple(g.shape) != (moved.shape[0], e) or \
            tuple(ids.shape) != (moved.shape[0],):
        raise ValueError(f"want moved [n, W], g [n, {e}], ids [n]; got {tuple(moved.shape)}, "
                         f"{tuple(g.shape)}, {tuple(ids.shape)}")
    if moved.dtype != torch.uint8 or g.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"want moved uint8, g float32, ids int32; got {moved.dtype}, "
                        f"{g.dtype}, {ids.dtype}")
    if e < 1 or e + 8 > moved.shape[1]:
        raise ValueError(f"rows of {moved.shape[1]} bytes cannot hold {e} q bytes, a scale and "
                         f"an accumulator")


def _launch(moved: torch.Tensor, g: torch.Tensor, ids: torch.Tensor, salt: torch.Tensor,
            lr: float, e: int, eps: float) -> torch.Tensor:
    for name, t in (("moved", moved), ("g", g), ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"requantize_rows kernel takes contiguous tensors; {name} is not")
        if t.device != moved.device:
            raise ValueError(f"{name} is on {t.device}, moved on {moved.device}")
    n, w = moved.shape
    geometry = requantize_geometry(w, e)
    if moved.data_ptr() % 4:
        raise ValueError("requantize_rows kernel reads rows as 4-byte words: moved must start "
                         "at a 4-byte aligned address")
    out = torch.empty((n, w), dtype=torch.uint8, device=moved.device)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(moved.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.requantize_rows_launch(moved.data_ptr(), g.data_ptr(), ids.data_ptr(),
                                         out.data_ptr(), n, w, e, salt.data_ptr(), lr, eps,
                                         geometry.group, geometry.words, geometry.unit, stream)
    if err != 0:
        raise RuntimeError("requantize_rows kernel launch failed: "
                           + lib.requantize_error_string(err).decode())
    count_launch(requantize_rows)
    return out


def requantize_rows(moved: torch.Tensor, g: torch.Tensor, ids: torch.Tensor,
                    salt: Union[int, torch.Tensor], lr: float, e: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """Rowwise Adagrad and id-keyed stochastic requantization of int8 packed
    rows with one scale a row: ``moved [n, W]`` u8 permuted
    ``q || scale || acc || ...`` rows, ``g [n, e]`` f32 summed grads,
    ``ids [n]`` int32 global row ids, ``salt`` a uint32 or its device word
    (``salt_word``; the kernel reads the salt from it) -> a new ``[n, W]``
    u8, ``q' || scale' || acc'`` then zeros. Needs ``e + 8 <= W``; on the
    card also ``e <= REQUANTIZE_MAX_E`` (512) and ``W <= 4096``, a multiple
    of 4, the rows at a 4-byte aligned address (``requantize_geometry``)."""
    _check(moved, g, ids, e)
    salt = salt_word(salt, moved.device)
    if launches_kernel(moved, g, ids):
        return _launch(moved, g, ids, salt, lr, e, eps)
    return requantize_rows_plain(moved, g, ids, salt, lr, e, eps)


requantize_rows.launches = 0


def stochastic_quantize_rows_plain(rows: torch.Tensor, rng_bits: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of B8: ``quantize_rows`` at int8 with one
    scale a row and the given bits."""
    return quantize_rows(rows, rng_bits=rng_bits, bits=8, col_groups=1)


def stochastic_quantize_rows_keyed_plain(rows: torch.Tensor, ids: torch.Tensor,
                                         salt: Union[int, torch.Tensor]
                                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of B8's keyed form: the id-keyed bits of
    ``ids`` and ``salt`` (the int64 hash), then the given-bits version."""
    bits = rounding_bits_i32(id_keyed_rounding_bits(ids, rows.shape[1], salt))
    return stochastic_quantize_rows_plain(rows, bits)


@dataclasses.dataclass(frozen=True)
class QuantizeGeometry:
    """How B8 lays out one call: ``group`` lanes a row (``32 // group`` rows
    a warp); ``words`` False for the scalar path (a column at a time, the row
    read twice), True for the words path (a lane holds 4 columns, read once
    with a 16-byte load and stored as one 32-bit q word)."""

    group: int
    words: bool


def quantize_geometry(e: int, aligned: bool = True) -> QuantizeGeometry:
    """B8's layout for rows of ``e`` columns. Plain Python: the tests check it
    on the CPU. Where ``e`` is a multiple of 4, at most 128 (32 lanes of one
    word), and the rows (and given bits) start at 16-byte aligned addresses
    (``aligned``), a row takes its words' count of lanes, rounded up to a
    power of two; otherwise the scalar path gives a row the smallest power
    of two >= e lanes, at most 32."""
    if e < 1:
        raise ValueError(f"B8 takes rows of at least one column, got e={e}")
    if e % 4 or e > 128 or not aligned:
        return QuantizeGeometry(min(32, 1 << (e - 1).bit_length()), False)
    return QuantizeGeometry(1 << (e // 4 - 1).bit_length(), True)


@functools.cache
def _quantize_kernel():
    lib = library("quantize")
    lib.quantize_rows_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.quantize_rows_launch.restype = ctypes.c_int
    lib.quantize_kernel_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_int),
                                               ctypes.POINTER(ctypes.c_int)]
    lib.quantize_kernel_attributes.restype = ctypes.c_int
    lib.quantize_error_string.argtypes = [ctypes.c_int]
    lib.quantize_error_string.restype = ctypes.c_char_p
    return lib


def quantize_launch_info(e: int, keyed: bool = True) -> dict:
    """B8's launch at ``e`` columns (aligned rows) on the current card: the
    geometry, the registers a thread and its local memory (stack and spills)
    in bytes."""
    geometry = quantize_geometry(e)
    lib = _quantize_kernel()
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.quantize_kernel_attributes(int(keyed), int(geometry.words), ctypes.byref(regs),
                                         ctypes.byref(local))
    if err != 0:
        raise RuntimeError("stochastic_quantize_rows kernel attributes: "
                           + lib.quantize_error_string(err).decode())
    return {"group": geometry.group, "rows_per_warp": 32 // geometry.group,
            "words": geometry.words, "registers": regs.value, "local_bytes": local.value}


def _launch_quantize(rows: torch.Tensor, rng_bits: Optional[torch.Tensor],
                     ids: Optional[torch.Tensor], salt: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    name, given = ("rng_bits", rng_bits) if rng_bits is not None else ("ids", ids)
    for label, t in (("rows", rows), (name, given)):
        if not t.is_contiguous():
            raise ValueError(f"stochastic_quantize_rows kernel takes contiguous tensors; {label} "
                             f"is not")
    if given.device != rows.device:
        raise ValueError(f"{name} is on {given.device}, rows on {rows.device}")
    n, e = rows.shape
    aligned = rows.data_ptr() % 16 == 0 and (rng_bits is None or rng_bits.data_ptr() % 16 == 0)
    geometry = quantize_geometry(e, aligned)
    q = torch.empty((n, e), dtype=torch.int8, device=rows.device)
    scale = torch.empty((n,), dtype=torch.float32, device=rows.device)
    if n == 0:
        return q, scale
    lib = _quantize_kernel()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.quantize_rows_launch(
            rows.data_ptr(), None if rng_bits is None else rng_bits.data_ptr(),
            None if ids is None else ids.data_ptr(), None if salt is None else salt.data_ptr(),
            q.data_ptr(), scale.data_ptr(), n, e, geometry.group, int(geometry.words), stream)
    if err != 0:
        raise RuntimeError("stochastic_quantize_rows kernel launch failed: "
                           + lib.quantize_error_string(err).decode())
    count_launch(stochastic_quantize_rows)
    return q, scale


def _check_quantize(rows: torch.Tensor, rng_bits: Optional[torch.Tensor],
                    ids: Optional[torch.Tensor], salt) -> None:
    if (rng_bits is None) == (ids is None and salt is None):
        raise ValueError("pass rng_bits, or ids and salt, not both and not neither")
    if rows.dim() != 2 or rows.shape[1] < 1:
        raise ValueError(f"want rows [n, E >= 1]; got {tuple(rows.shape)}")
    if rows.dtype != torch.float32:
        raise TypeError(f"want rows float32; got {rows.dtype}")
    if rng_bits is not None:
        if tuple(rng_bits.shape) != tuple(rows.shape):
            raise ValueError(f"want rng_bits of the rows' shape {tuple(rows.shape)}; got "
                             f"{tuple(rng_bits.shape)}")
        if rng_bits.dtype != torch.int32:
            raise TypeError(f"want rng_bits int32; got {rng_bits.dtype}")
        return
    if ids is None or salt is None:
        raise ValueError("the keyed form takes ids and salt together")
    if tuple(ids.shape) != (rows.shape[0],):
        raise ValueError(f"want ids [{rows.shape[0]}]; got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"want ids int32; got {ids.dtype}")


def stochastic_quantize_rows(rows: torch.Tensor, rng_bits: Optional[torch.Tensor] = None, *,
                             ids: Optional[torch.Tensor] = None,
                             salt: Union[int, torch.Tensor, None] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8: ``rows [n, E]`` f32 -> ``(q [n, E] int8, scale [n] f32)``:
    ``scale = absmax / 127`` (1 for an all-zero row) and
    ``q = clip(floor(row / scale + (bits >> 8) * 2**-24), -127, 127)``.
    The bits are either given, ``rng_bits [n, E]`` int32 (uint32 bit
    patterns, ``rounding_bits_i32``), or keyed: ``ids [n]`` int32 global row
    ids and ``salt`` a uint32 or its device word (``salt_word``; the kernel
    reads the salt from it), the bits ``id_keyed_rounding_bits(ids, E,
    salt)``, which the kernel makes itself. Pass one form, not both."""
    _check_quantize(rows, rng_bits, ids, salt)
    if rng_bits is not None:
        if launches_kernel(rows, rng_bits):
            return _launch_quantize(rows, rng_bits, None, None)
        return stochastic_quantize_rows_plain(rows, rng_bits)
    salt = salt_word(salt, rows.device)
    if launches_kernel(rows, ids):
        return _launch_quantize(rows, None, ids, salt)
    return stochastic_quantize_rows_keyed_plain(rows, ids, salt)


stochastic_quantize_rows.launches = 0
