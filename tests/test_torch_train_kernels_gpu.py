"""The training path's kernels against their plain versions, on the card:
the segmented scan, the row scatter-set and the cross network's gradient.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_train_kernels_gpu.py

Tolerances: the scan rtol 1e-5 / atol 1e-5 (sums in another order; atol
1e-4 where segments run 10k rows; exact on values whose partial sums are all
exact in f32), the scatter bit-exact, the gradient
rtol 1e-4 / atol 1e-6 (the kernel's forward against cuBLAS).
"""

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch.ops.kernels.cross import cross_network, cross_network_plain
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows, scatter_set_rows_plain
from pytorchrec_tpu_torch.ops.kernels.seg_scan import (
    segmented_sum_scan,
    segmented_sum_scan_plain,
)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _sorted_heads(ids: np.ndarray) -> np.ndarray:
    ids = np.sort(ids)
    return np.concatenate([[True], ids[1:] != ids[:-1]])


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,skew", [(1, 16, False), (2, 16, False), (1000, 16, False),
                                      (851_968, 16, False), (200_000, 16, True),
                                      (5000, 4, True), (3333, 37, False), (700, 256, True),
                                      (851_968, 1, False), (5000, 1, True), (3000, 257, True),
                                      (20_000, 300, False), (4000, 512, True)])
def test_seg_scan_kernel_matches_plain(n, e, skew):
    _need_card()
    rng = np.random.default_rng(n + e)
    ids = (np.minimum(rng.zipf(1.2, n), 1000) if skew else rng.integers(0, 100_000 * 26, n))
    heads = torch.from_numpy(_sorted_heads(ids)).cuda()
    wide = torch.from_numpy(rng.normal(size=(n, e + 12)).astype(np.float32)).cuda()
    x = wide[:, 5:5 + e]  # a column slice, as the packed update passes it
    before = segmented_sum_scan.launches
    got = segmented_sum_scan(x, heads)
    torch.cuda.synchronize()
    assert segmented_sum_scan.launches == before + 1
    atol = 1e-4 if skew else 1e-5
    torch.testing.assert_close(got, segmented_sum_scan_plain(x, heads), rtol=1e-5, atol=atol)


def _scan_and_compare(x, heads, atol=1e-5):
    before = segmented_sum_scan.launches
    got = segmented_sum_scan(x, heads)
    torch.cuda.synchronize()
    assert segmented_sum_scan.launches == before + 1
    assert got.shape == x.shape and got.is_contiguous()
    torch.testing.assert_close(got, segmented_sum_scan_plain(x, heads), rtol=1e-5, atol=atol)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("e", [1, 16, 64, 257, 300])
@pytest.mark.parametrize("n_from_tile", ["1", "tile-1", "tile", "tile+1", "3 tiles+1"])
def test_look_back_scan_at_tile_edges(e, n_from_tile):
    """n at one row and at a tile's size (B2's rows a tile at E's first
    chunk) minus one, plus none and plus one, and past a few tiles, with
    segments that cross tile borders."""
    _need_card()
    from pytorchrec_tpu_torch.ops.kernels.seg_scan import _kernel
    tile = _kernel().seg_scan_tile_rows(min(e, 256))
    n = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "3 tiles+1": 3 * tile + 1}[n_from_tile]
    rng = np.random.default_rng(n * 7 + e)
    heads = torch.from_numpy(_sorted_heads(rng.integers(0, max(2, n // 50), n))).cuda()
    wide = torch.from_numpy(rng.normal(size=(n, e + 12)).astype(np.float32)).cuda()
    _scan_and_compare(wide[:, 4:4 + e], heads)


@pytest.mark.gpu
@pytest.mark.parametrize("n,e", [(851_968, 16), (851_968, 1), (90_112, 64), (20_000, 300)])
def test_look_back_scan_one_segment_over_every_row(n, e):
    """One segment over every row: each tile's carry comes from the whole
    chain of predecessors. The values are multiples of 1/16 in [-0.5, 0.5],
    so every partial sum is exact in f32 and any summation order gives the
    plain version's bits: the check is exact."""
    _need_card()
    rng = np.random.default_rng(n + e)
    heads = torch.zeros((n,), dtype=torch.bool, device="cuda")
    heads[0] = True
    x = torch.from_numpy(rng.integers(-8, 9, (n, e)).astype(np.float32) / 16).cuda()
    got = _scan_and_compare(x, heads, atol=0.0)
    assert torch.equal(got, segmented_sum_scan_plain(x, heads))
    # and with no head at all: the same sums (row 0 starts the running sum)
    assert torch.equal(segmented_sum_scan(x, torch.zeros_like(heads)), got)


@pytest.mark.gpu
@pytest.mark.parametrize("n,e", [(851_968, 16), (851_968, 1), (90_112, 64), (20_000, 300)])
@pytest.mark.parametrize("segments", ["one", "skewed"])
def test_look_back_scan_repeats_its_bits(n, e, segments):
    """Normal values, whose sums round: the look-back adds its predecessors'
    aggregates in an order fixed by the heads, so ten calls on one input
    give one result, bit for bit."""
    _need_card()
    rng = np.random.default_rng(n + 3 * e)
    if segments == "one":
        heads = torch.zeros((n,), dtype=torch.bool, device="cuda")
        heads[0] = True
    else:
        heads = torch.from_numpy(_sorted_heads(np.minimum(rng.zipf(1.2, n), 1000))).cuda()
    x = torch.from_numpy(rng.normal(size=(n, e)).astype(np.float32)).cuda()
    first = segmented_sum_scan(x, heads)
    for _ in range(9):
        assert torch.equal(segmented_sum_scan(x, heads), first)


@pytest.mark.gpu
def test_look_back_scan_takes_no_rows():
    _need_card()
    x = torch.zeros((0, 16), device="cuda")
    out = segmented_sum_scan(x, torch.zeros((0,), dtype=torch.bool, device="cuda"))
    assert out.shape == (0, 16)


@pytest.mark.gpu
def test_look_back_scans_back_to_back_without_a_sync():
    """Calls queued one after another on the stream, the caching allocator
    handing each the scratch the one before freed: each call zeroes its
    ticket and status words on the stream, so each gives the plain version's
    bits. The values are multiples of 1/16 in [-0.5, 0.5], so every partial
    sum is exact in f32 and the check is exact: a status word left from the
    call before would show."""
    _need_card()
    rng = np.random.default_rng(11)
    inputs = []
    for k in range(4):  # the update's shape, then skewed ids: segments of 50k rows
        n = 200_000 if k % 2 else 851_968
        ids = np.minimum(rng.zipf(1.2, n), 1000) if k % 2 else rng.integers(0, 2_600_000, n)
        heads = torch.from_numpy(_sorted_heads(ids)).cuda()
        wide = torch.from_numpy(rng.integers(-8, 9, (n, 64)).astype(np.float32) / 16).cuda()
        inputs.append((wide[:, 48:64], heads))
    torch.cuda.synchronize()
    outs = [segmented_sum_scan(x, heads) for x, heads in inputs + inputs]
    torch.cuda.synchronize()
    for k, (x, heads) in enumerate(inputs + inputs):
        assert torch.equal(outs[k], segmented_sum_scan_plain(x, heads))


@pytest.mark.gpu
def test_look_back_scan_on_the_int8_rows_slice():
    """The int8 update's scan: f32 columns 24 bytes into 128-byte rows (8-byte
    aligned: loads of 2 floats)."""
    _need_card()
    from pytorchrec_tpu_torch.ops.kernels.seg_scan import scan_vector_width
    rng = np.random.default_rng(24)
    n, e = 851_968, 16
    heads = torch.from_numpy(_sorted_heads(rng.integers(0, 2_600_000, n))).cuda()
    rows = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32)).cuda()
    x = rows.view(torch.uint8)[:, 24:24 + 4 * e].view(torch.float32)
    assert x.stride() == (32, 1) and x.data_ptr() % 16 == 8
    assert scan_vector_width(x.data_ptr(), x.stride(0), e) == 2
    _scan_and_compare(x, heads)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,w", [(torch.float32, 64), (torch.float32, 13),
                                     (torch.uint8, 128), (torch.uint8, 7)])
def test_scatter_kernel_is_bit_exact(dtype, w):
    _need_card()
    rng = np.random.default_rng(w)
    v, n = 100_000, 300_000
    ids = np.sort(rng.integers(0, v, n)).astype(np.int32)
    last = np.concatenate([ids[1:] != ids[:-1], [True]])
    safe = torch.from_numpy(np.where(last, ids, v + np.arange(n)).astype(np.int32)).cuda()
    table = torch.from_numpy(rng.integers(0, 255, (v, w)).astype(np.uint8)).cuda().to(dtype)
    rows = torch.from_numpy(rng.integers(0, 255, (n, w)).astype(np.uint8)).cuda().to(dtype)
    want = scatter_set_rows_plain(table.clone(), rows, safe)
    before = scatter_set_rows.launches
    scatter_set_rows(table, rows, safe)
    torch.cuda.synchronize()
    assert scatter_set_rows.launches == before + 1
    assert torch.equal(table, want)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,dim,layers", [(4096, 429, 3), (37, 29, 1), (4096, 1677, 3)])
def test_cross_gradient_on_card_matches_plain_autograd(batch, dim, layers):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(batch)
    arrays = [rng.normal(size=(batch, dim)), rng.normal(size=(layers, dim, dim)) * 0.01,
              rng.normal(size=(layers, dim)) * 0.01]
    g = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).cuda()

    def grads(fn):
        leaves = [torch.from_numpy(a.astype(np.float32)).cuda().requires_grad_() for a in arrays]
        out = fn(*leaves)
        assert out.grad_fn is not None
        out.backward(g)
        return [t.grad for t in leaves]

    before = cross_network.launches
    got = grads(cross_network)
    torch.cuda.synchronize()
    assert cross_network.launches == before + 1
    for a, b in zip(got, grads(cross_network_plain)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
