"""The cross-network CUDA kernel against its plain version, on the card.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_cross_gpu.py

Tolerance rtol 1e-4 / atol 1e-6: the f32 sums of D terms may run in another
order in the kernel than in cuBLAS. The wrapper's plan (``cross_plan``)
runs the fused form at large batches and D <= its widest, the tiled form
elsewhere; batches not a multiple of a tile, D = 1, 429 and 512, the widths
past the fused form's (513, 1677, 2048) and batches of 2 to 8 rows reach
every form's edges. Where cuBLAS sums in one k-order accumulator the kernel
does too, bit for bit; where cuBLAS splits k the plan splits it finer, so
the kernel agrees wherever cuBLAS's sums agree with the exact ones. Past
D = 512 cuBLAS's own sums can lie outside the tolerance from the exact ones
(``ROADMAP.md`` C1, closed), so there the kernel is held to the exact sums
(``exact_gate``) and not to cuBLAS's.
"""

import numpy as np
import pytest
import torch

import pytorchrec_tpu_torch.ops.kernels.cross as cross_module
from pytorchrec_tpu_torch.ops.kernels.cross import (
    FUSED_MAX_WIDTH,
    K_TILE,
    ROW_TILE,
    TILES,
    CrossPlan,
    cross_network,
    cross_network_exact,
    cross_network_plain,
    cross_plan,
    exact_gate,
)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("batch,dim,layers", [(1, 429, 3), (1000, 429, 3), (32768, 429, 3),
                                              (37, 37, 3), (65, 8, 1), (33, 512, 2),
                                              (4097, 429, 3), (1000, 512, 2), (1000, 512, 3),
                                              (131, 1, 3), (1, 1, 2), (63, 100, 3), (200, 64, 4),
                                              (2, 429, 3), (5, 1677, 3), (8, 512, 3),
                                              (999, 512, 3), (1024, 512, 3), (1000, 500, 3)])
def test_cross_kernel_matches_plain_on_card(batch, dim, layers):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(batch + dim)
    x0 = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).cuda()
    ws = torch.from_numpy((rng.normal(size=(layers, dim, dim)) * 0.01).astype(np.float32)).cuda()
    bs = torch.from_numpy((rng.normal(size=(layers, dim)) * 0.01).astype(np.float32)).cuda()
    before = cross_network.launches
    got = cross_network(x0, ws, bs)
    torch.cuda.synchronize()
    assert cross_network.launches == before + 1
    torch.testing.assert_close(got, cross_network_plain(x0, ws, bs), rtol=1e-4, atol=1e-6)


def _inputs(batch, dim, layers):
    rng = np.random.default_rng(batch + dim)
    x0 = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).cuda()
    ws = torch.from_numpy((rng.normal(size=(layers, dim, dim)) * 0.01).astype(np.float32)).cuda()
    bs = torch.from_numpy((rng.normal(size=(layers, dim)) * 0.01).astype(np.float32)).cuda()
    return x0, ws, bs


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [513, 1677, 2048])
@pytest.mark.parametrize("batch", [1, 1000, 4097, 32768])
def test_cross_kernel_takes_any_width(batch, dim):
    """Past the fused form's widest D the tiled form runs; no width limit is
    raised. Past D = 512 the kernel is held to the exact sums
    (``exact_gate``): within rtol 1e-4 / atol 1e-6 of them, or no farther
    from them than cuBLAS's ``torch.mm`` where cuBLAS is outside it."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x0, ws, bs = _inputs(batch, dim, 3)
    before = cross_network.launches
    got = cross_network(x0, ws, bs)
    torch.cuda.synchronize()
    assert cross_network.launches == before + 1
    plain = cross_network_plain(x0, ws, bs)
    if dim <= FUSED_MAX_WIDTH:
        torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-6)
        return
    gate = exact_gate(got, plain, cross_network_exact(x0, ws, bs))
    assert gate["ok"], (f"kernel {gate['kernel']:.3f} x the tolerance from the exact sums, "
                        f"cuBLAS {gate['cublas']:.3f} x")


@pytest.mark.gpu
@pytest.mark.parametrize("batch,dim,tile", [
    *((b, d, t) for b, d in ((70, 429), (1000, 429), (129, 37)) for t in range(1, 5)),
    *((1000, 2048, t) for t in range(1, ROW_TILE))])
def test_every_tile_gives_the_same_sums(batch, dim, tile, monkeypatch):
    """The tile sets no summation order: every tile of the tiled form gives
    the same bits with the same k-slices, the plan's (the 128 x 128 tile
    does not split k: where the plan splits, it is held to the 64 x 128
    tile's sums in one slice)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x0, ws, bs = _inputs(batch, dim, 2)
    plan = cross_plan(batch, dim)
    if TILES[tile] == (128, 128) and plan.splits > 1:
        plan = CrossPlan("tiled", TILES.index((64, 128)), dim, -(-dim // K_TILE) * K_TILE)
        monkeypatch.setattr(cross_module, "cross_plan", lambda *_: plan)
    want = cross_network(x0, ws, bs)
    monkeypatch.setattr(cross_module, "cross_plan",
                        lambda *_: CrossPlan(**{**plan.__dict__, "tile": tile}))
    got = cross_network(x0, ws, bs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
