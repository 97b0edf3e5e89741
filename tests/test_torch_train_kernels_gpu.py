"""The training path's kernels against their plain versions, on the card:
the segmented scan, the row scatter-set and the cross network's gradient.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_train_kernels_gpu.py

Tolerances: the scan rtol 1e-5 / atol 1e-5 (sums in another order; atol
1e-4 where segments run 10k rows), the scatter bit-exact, the gradient
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
                                      (851_968, 1, False), (5000, 1, True)])
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
@pytest.mark.parametrize("batch,dim,layers", [(4096, 429, 3), (37, 29, 1)])
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
