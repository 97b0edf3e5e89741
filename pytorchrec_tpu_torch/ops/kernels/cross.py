"""DCN-v2 cross network: CUDA kernels, their launch plan, plain version and wrapper.

Replaces ``pytorchrec_tpu/ops/kernels/cross.py::_cross_fwd_kernel`` (the
``pl.pallas_call`` of ``cross_network_pallas``). For ``x0 [B, D]``,
``ws [L, D, D]`` (``x @ W`` orientation) and ``bs [L, D]`` it computes all L
layers ``x_{l+1} = x0 * (x_l @ W_l + b_l) + x_l`` and returns ``x_L``, for
any D and any batch, as the JAX module does.

``csrc/cross.cu`` holds two hand-written forms, and ``cross_plan`` picks one
by shape:

* **fused**: a block keeps its 64 rows of ``x_l`` in shared memory across
  all layers and streams ``W_l`` from L2, so ``x_l`` makes no round trip
  through device memory. Its block holds all of D, so it takes widths up to
  ``FUSED_MAX_WIDTH``; one block an SM fills the 132 SMs only from about
  8,400 rows.
* **tiled**: one GEMM a layer over (row tile x column tile) blocks with the
  cross update in its epilogue; it takes any D. It sums k in one k-order
  slice, or in contiguous k-slices summed one after another and added in
  order; up to 8 rows its rows tile deals k to the 32 lanes of a warp.

``cross_plan``'s docstring gives the rule and ``PERF.md`` the card
measurements behind it. Both forms are bound by operations at the training
shape: ``2*B*D^2*L`` f32 FMA-operations, 0.54 ms on the H100 at
(B=32768, D=429, L=3) against 0.034 ms of memory.

``cross_network`` dispatches by device through the op
``torch.ops.pytorchrec.cross_network`` (``ops/kernels/__init__.py``): a CUDA
tensor launches the planned form and raises if a launch fails; a CPU tensor
runs ``cross_network_plain``; ``torch.export`` keeps the op in its graph.
Choosing between the two hand-written forms by shape is the kernel's own
plan: the plain version never runs on the card.
``cross_network.launches`` counts wrapper calls that launched a form,
however many CUDA launches the plan takes.

Gradient. When grad mode is on and an input requires grad, the forward runs
inside ``CrossNetworkFunction`` (a ``torch.autograd.Function``), whose
backward is the JAX package's custom-VJP formula
(``pytorchrec_tpu/ops/kernels/cross.py`` ``bwd``) in plain torch: the layer
inputs are recomputed, then the layers are walked back. The JAX package has
no backward kernel either (XLA runs it), so its products go to
``torch.mm``/``torch.addmm``, which take any D.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from pytorchrec_tpu_torch.ops.kernels import count_launch, define_op, launches_kernel
from pytorchrec_tpu_torch.ops.kernels.build import library
from pytorchrec_tpu_torch.ops.precision import current_precision, precision_mm


def cross_network_plain(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: one matmul and one Hadamard per layer."""
    xl = x0
    for layer in range(ws.shape[0]):
        xl = x0 * (xl @ ws[layer] + bs[layer]) + xl
    return xl


def cross_network_exact(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """The reference the card's check holds the kernel to past
    ``FUSED_MAX_WIDTH``: per layer ``u = x_l @ W_l`` from float64 products of
    the f32 values, summed in float64 and rounded to f32, then
    ``x0 * (u + b) + x_l`` in f32. Any device."""
    xl = x0
    for layer in range(ws.shape[0]):
        u = (xl.double() @ ws[layer].double()).float()
        xl = x0 * (u + bs[layer]) + xl
    return xl


# The card's tolerance for the cross network: f32 sums of D terms in
# another order
CARD_RTOL, CARD_ATOL = 1e-4, 1e-6


def tolerance_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``max |got - ref| / (CARD_ATOL + CARD_RTOL |ref|)``: how much of the
    card's tolerance ``got`` takes from ``ref`` (at most 1.0 passes)."""
    return float(((got - ref).abs() / (CARD_ATOL + CARD_RTOL * ref.abs())).max())


def exact_gate(got: torch.Tensor, plain: torch.Tensor, exact: torch.Tensor) -> dict:
    """The card's check of the kernel past ``FUSED_MAX_WIDTH``: ``got`` is
    within the tolerance of the exact sums (``cross_network_exact``) or, where
    ``plain`` (cuBLAS's ``torch.mm``) is not, no farther from them than
    ``plain``. There cuBLAS splits k by a heuristic the port cannot see, and
    its own sums lie up to 4x the tolerance from the exact ones
    (``ROADMAP.md`` C1), so holding the kernel to cuBLAS's bits would hold it
    to that heuristic. Returns both shares and whether the gate passes."""
    kernel, cublas = tolerance_share(got, exact), tolerance_share(plain, exact)
    return {"kernel": kernel, "cublas": cublas, "ok": kernel <= max(1.0, cublas)}


# The fused form's widest D (csrc/cross.cu TN) and the batch from which it
# runs; below that batch, or past that width, the tiled form runs.
FUSED_MAX_WIDTH = 512
FUSED_MIN_ROWS = 8192
# The tiled form's tiles, (rows, columns) a block, as csrc/cross.cu lists
# them. Tiles 0 and ROW_TILE are the rows tile (up to 8 rows, one row): k
# dealt to 32 lanes, added in a tree.
TILES = ((8, 8), (8, 64), (32, 64), (64, 64), (64, 128), (128, 128), (1, 8))
ROW_TILE = 6
ROWS_MAX = 8  # batches the rows tile takes
K_TILE = 16  # the tiles' k step: every slice but the last is a multiple of it
MAX_SLICES = 16  # the most k-slices a plan cuts
SM_COUNT = 132  # the H100's SMs, for plans made without a card
# The tiled form splits k where its grid of 64 x 64 output tiles is at most
# this many waves of the SMs, which is about where cuBLAS splits k (PERF.md).
SPLIT_MAX_WAVES = 1.5


@dataclasses.dataclass(frozen=True)
class CrossPlan:
    """How one call runs: ``form`` "fused" or "tiled"; for the tiled form
    the index of its tile in ``TILES``; and ``slice_k``, the k a slice:
    slice s takes k = s * slice_k .. min(d, (s + 1) * slice_k) - 1 in order
    (one slice where slice_k >= d; the rows tile deals k to its lanes and
    has one slice)."""

    form: str
    tile: Optional[int]
    d: int
    slice_k: int

    @property
    def splits(self) -> int:
        return -(-self.d // self.slice_k)

    def slices(self) -> list:
        """Each slice's k, in the order it sums them."""
        return [list(range(lo, min(self.d, lo + self.slice_k)))
                for lo in range(0, self.d, self.slice_k)]


def cross_plan(batch: int, d: int, sm_count: int = SM_COUNT) -> CrossPlan:
    """The form, tile and k-slices of every layer for ``x0 [batch, d]`` on a
    card of ``sm_count`` SMs. Plain Python: the tests check it on the CPU.

    * fused where d <= FUSED_MAX_WIDTH and batch >= FUSED_MIN_ROWS;
    * the rows tile up to ROWS_MAX rows;
    * else the tiled form. Its tile: 128 x 128 where that grid is 8 blocks an
      SM or more, else the widest of 64 x 128, 64 x 64 and 32 x 64 whose grid
      is half the SMs or more, else 8 x 64. Its k: up to MAX_SLICES
      contiguous slices, each a multiple of K_TILE but the last, where the
      grid of 64 x 64 output tiles is at most SPLIT_MAX_WAVES waves of the
      SMs, and past FUSED_MAX_WIDTH wherever the tile is not 128 x 128 (that
      tile does not split); one slice elsewhere.

    Why these k-slices. The card's checks hold the kernel to cuBLAS's
    ``torch.mm`` at rtol 1e-4 / atol 1e-6 up to D = 512, and past it to
    the exact sums (``exact_gate``). Traced on the H100 (cuBLAS 12.8)
    over B in 1..32768 and D in 1..4096, cuBLAS sums in one k-order
    accumulator where its grid fills the card: the fused form's and one
    slice's sums, bit for bit. Where the grid is small it splits k, in 2 to
    33 slices whose count and order its heuristic picks by shape, and its
    sums are then the more accurate: a kernel that sums in one accumulator
    falls outside the tolerance there. Sixteen slices sum about as
    accurately as float64 products rounded to f32, so the kernel then
    agrees with cuBLAS wherever cuBLAS agrees with the exact sums: at every
    traced shape with D <= 512. Past D = 512 one accumulator of D terms
    lands 0.9 to 8.7 times the tolerance from the exact sums at 512 rows
    and more, and 16 slices 0.3 to 1.9 times (``PERF.md``), while
    cuBLAS's heuristic splits at some of those shapes and not at others;
    so there the kernel splits wherever its tile can. The 128 x 128 tile
    runs on grids of 8 blocks an SM or more, where cuBLAS sums unsplit too
    (equal bits), and splitting there would cost 57% at 32768 x 1677.
    """
    if d < 1 or batch < 0 or sm_count < 1:
        raise ValueError(f"no plan for batch={batch}, d={d}, sm_count={sm_count}")
    one_slice = -(-d // K_TILE) * K_TILE
    if d <= FUSED_MAX_WIDTH and batch >= FUSED_MIN_ROWS:
        return CrossPlan("fused", None, d, one_slice)
    if batch <= ROWS_MAX:
        return CrossPlan("tiled", ROW_TILE if batch == 1 else 0, d, one_slice)

    def blocks(tile: int) -> int:
        bm, bn = TILES[tile]
        return -(-batch // bm) * -(-d // bn)

    tile = 5 if blocks(5) >= 8 * sm_count else next(
        (t for t in (4, 3, 2) if 2 * blocks(t) >= sm_count), 1)
    if blocks(3) > SPLIT_MAX_WAVES * sm_count and (d <= FUSED_MAX_WIDTH or tile == 5):
        return CrossPlan("tiled", tile, d, one_slice)
    return CrossPlan("tiled", tile, d, -(-(-(-d // MAX_SLICES)) // K_TILE) * K_TILE)


@functools.cache
def _kernel():
    lib = library("cross")
    lib.cross_network_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.cross_network_fwd.restype = ctypes.c_int
    lib.cross_network_tiled_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                            + [ctypes.c_void_p])
    lib.cross_network_tiled_fwd.restype = ctypes.c_int
    lib.cross_network_tiled_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cross_network_tiled_tile.restype = ctypes.c_int
    lib.cross_network_smem_bytes.argtypes = [ctypes.c_int]
    lib.cross_network_smem_bytes.restype = ctypes.c_longlong
    lib.cross_network_error_string.argtypes = [ctypes.c_int]
    lib.cross_network_error_string.restype = ctypes.c_char_p
    built = tuple((lib.cross_network_tiled_tile(t, 0), lib.cross_network_tiled_tile(t, 1))
                  for t in range(len(TILES)))
    if built != TILES:
        raise RuntimeError(f"csrc/cross.cu's tiles {built} differ from TILES {TILES}")
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> None:
    if x0.dim() != 2 or ws.dim() != 3 or bs.dim() != 2:
        raise ValueError(f"want x0 [B, D], ws [L, D, D], bs [L, D]; got "
                         f"{tuple(x0.shape)}, {tuple(ws.shape)}, {tuple(bs.shape)}")
    num_layers, d = ws.shape[0], x0.shape[1]
    if tuple(ws.shape) != (num_layers, d, d) or tuple(bs.shape) != (num_layers, d):
        raise ValueError(f"ws {tuple(ws.shape)} / bs {tuple(bs.shape)} do not fit D={d}")


def _launch(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """Launch the form ``cross_plan`` picks, on CUDA tensors."""
    for name, t in (("x0", x0), ("ws", ws), ("bs", bs)):
        if t.dtype != torch.float32:
            raise TypeError(f"cross_network kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cross_network kernel takes contiguous tensors; {name} is not")
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
    batch, d = x0.shape
    layers = ws.shape[0]
    if batch * d >= 2**31 or d * d >= 2**31:
        raise ValueError(f"shape {tuple(x0.shape)} exceeds the kernel's int32 indexing")
    out = torch.empty_like(x0)
    if batch == 0:
        return out
    lib = _kernel()
    plan = cross_plan(batch, d, _sm_count(x0.device.index or 0))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.form == "fused":
            smem = lib.cross_network_smem_bytes(d)
            limit = torch.cuda.get_device_properties(x0.device).shared_memory_per_block_optin
            if d > FUSED_MAX_WIDTH or smem > limit:
                raise ValueError(f"the fused cross kernel needs {smem} B of shared memory at "
                                 f"D={d}; the device allows {limit} B a block")
            err = lib.cross_network_fwd(x0.data_ptr(), ws.data_ptr(), bs.data_ptr(),
                                        out.data_ptr(), batch, d, layers, stream)
        else:
            buf = x0.new_empty((min(layers - 1, 2), batch, d))
            # the tiles copy W 16 bytes at a time: rows of a multiple of 4
            # floats, zero past D (the rows tile reads ws as it is). The copy
            # costs less than 4-byte copies of W in the kernel (PERF.md).
            wp = ws
            if plan.tile not in (0, ROW_TILE) and d % 4:
                wp = torch.nn.functional.pad(ws, (0, -d % 4))
            elif plan.tile not in (0, ROW_TILE) and ws.data_ptr() % 16:
                wp = ws.clone()
            err = lib.cross_network_tiled_fwd(x0.data_ptr(), wp.data_ptr(), bs.data_ptr(),
                                              out.data_ptr(), buf.data_ptr(), batch, d, layers,
                                              plan.tile, plan.slice_k, wp.shape[2], stream)
    if err != 0:
        raise RuntimeError(f"cross_network {plan.form} kernel launch failed: "
                           + lib.cross_network_error_string(err).decode())
    count_launch(cross_network)
    return out


CROSS_OP = define_op("cross_network", _launch, cross_network_plain,
                     lambda x0, ws, bs: torch.empty_like(x0))


def _forward(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    launches_kernel(x0, ws, bs)  # one kind of device
    return CROSS_OP(x0, ws, bs)


def cross_network_backward(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
                           g: torch.Tensor, precision: Optional[str] = None):
    """``(dx0, dws, dbs)`` for the upstream gradient ``g = dL/dx_L``.

    With ``u_l = x_l W_l + b_l``: ``dW_l = x_l^T (g_l * x0)``,
    ``db_l = sum_rows(g_l * x0)``, ``dx0 += g_l * u_l`` and
    ``g_{l-1} = (g_l * x0) W_l^T + g_l``; ``x_0`` is ``x0``, so the walked-back
    ``g`` lands on ``dx0`` at the end. ``u_l`` is kept from the recompute, so
    the backward runs 3 products a layer, each at ``precision``
    (``ops/precision.py``: the matmul precision of the forward's train
    step)."""
    xs, us = [], []
    xl = x0
    for layer in range(ws.shape[0]):
        u = precision_mm(xl, ws[layer], precision, bias=bs[layer])
        xs.append(xl)
        us.append(u)
        xl = x0 * u + xl
    dx0 = torch.zeros_like(x0)
    dws, dbs = [None] * len(xs), [None] * len(xs)
    for layer in reversed(range(len(xs))):
        gx0 = g * x0
        dws[layer] = precision_mm(xs[layer].t(), gx0, precision)
        dbs[layer] = gx0.sum(dim=0)
        dx0 = dx0 + g * us[layer]
        g = precision_mm(gx0, ws[layer].t(), precision) + g
    return dx0 + g, torch.stack(dws), torch.stack(dbs)


class CrossNetworkFunction(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward with the
    closed-form backward of ``cross_network_backward``, at the matmul
    precision the forward ran under (the forward itself is f32)."""

    @staticmethod
    def forward(ctx, x0, ws, bs):
        ctx.save_for_backward(x0, ws, bs)
        ctx.precision = current_precision()
        return _forward(x0, ws, bs)

    @staticmethod
    def backward(ctx, g):
        x0, ws, bs = ctx.saved_tensors
        return cross_network_backward(x0, ws, bs, g.contiguous(), ctx.precision)


def cross_network(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """Cross network: ``x0 [B, D]``, ``ws [L, D, D]``, ``bs [L, D]`` ->
    ``x_L [B, D]``. ``L == 0`` is the identity and launches nothing. The
    result carries a gradient when grad mode is on and an input requires
    one."""
    _check(x0, ws, bs)
    if ws.shape[0] == 0:
        return x0
    if torch.is_grad_enabled() and (x0.requires_grad or ws.requires_grad or bs.requires_grad):
        return CrossNetworkFunction.apply(x0, ws, bs)
    return _forward(x0, ws, bs)


cross_network.launches = 0
