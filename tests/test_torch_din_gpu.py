"""The DIN attention-pooling kernel against its plain version, on the card.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_din_gpu.py

The kernel runs layer 0 in its split form (``w_0``'s row blocks combined
as it loads them, the t part once a (b, n) row of a tile); the cases reach
its paths: rows that span several chunks (S = 129 and 200), ragged last
tiles (B = 37), widths not a multiple of 32 (E = 40 and 96), a first layer
one column wide and one in two passes of columns, tiles of fewer rows than
fill a chunk (a wide first layer at S = 1 and 2), candidates equal to
history rows and rows with every step masked.

Two input scales: DIN's own (rows and weights N(0, 0.01), as the framework
initialises them: near-uniform softmax) and a spread one (rows N(0, 1),
weights N(0, 0.1): peaked softmax). Tolerance rtol 1e-4 / atol 1e-6, the
port's rule for f32 sums run in another order; the gradient through the
Function (whose backward is plain autograd either way) the same.
"""

import ctypes

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch.ops.kernels import din_attention as din

RTOL, ATOL = 1e-4, 1e-6
# (B, N, S, E, hidden, activation)
CASES = [
    (1, 1, 20, 64, (80, 40), "sigmoid"),
    (4096, 2, 20, 64, (80, 40), "sigmoid"),
    (1024, 100, 20, 64, (80, 40), "sigmoid"),
    (33, 3, 6, 8, (16, 8), "sigmoid"),
    (33, 3, 6, 8, (16, 8), "relu"),
    (20, 2, 4, 8, (8,), "sigmoid"),
    (20, 2, 5, 8, (16, 8, 4), "relu"),
    (1000, 3, 6, 8, (16, 8, 4), "relu"),  # many tiles a block, a buffer at two layers
    (17, 5, 1, 8, (16, 8), "sigmoid"),
    (9, 4, 7, 5, (12,), "sigmoid"),
    (7, 3, 100, 16, (32, 16), "sigmoid"),
    (5, 2, 9, 8, (128, 33), "sigmoid"),  # four columns a lane, one pass
    (5, 2, 9, 8, (150, 40), "sigmoid"),  # a first layer in two passes of columns
    (5, 2, 9, 8, (40, 160), "relu"),  # a second layer in two passes
    (5, 3, 129, 64, (80, 40), "sigmoid"),  # a row over two chunks, one row a tile
    (4, 2, 200, 64, (80, 40), "relu"),  # a row over two chunks, the second ragged
    (37, 1, 20, 64, (80, 40), "sigmoid"),  # N=1, the last tile one row of 6
    (37, 100, 20, 64, (80, 40), "sigmoid"),  # N=100, the last tile 4 rows of 6
    (33, 3, 20, 40, (80, 40), "sigmoid"),  # E not a multiple of 32
    (33, 3, 20, 96, (64, 32), "relu"),
    (37, 3, 20, 64, (1,), "sigmoid"),  # H1 = 1
    (37, 3, 20, 16, (150, 40), "sigmoid"),  # a first layer in two passes, ~220 KB shared
    (9, 3, 1, 8, (160, 40), "sigmoid"),  # S=1: 33 rows a tile, where 128 would not fit
    (300, 1, 2, 8, (160, 40), "relu"),  # S=2: 33 rows a tile, not 64
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(b, n, s, e, hidden, scale, seed):
    rng = np.random.default_rng(seed)
    row, weight = (0.01, 0.01) if scale == "din" else (1.0, 0.1)

    def normal(*shape, std):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32)).cuda()

    his, tgt = normal(b, s, e, std=row), normal(b, n, e, std=row)
    valid = torch.from_numpy(rng.integers(0, 2, size=(b, s)).astype(np.int32)).cuda()
    valid[:, 0] = 1
    dims = [4 * e, *hidden, 1]
    params = []
    for i in range(len(dims) - 1):
        params += [normal(dims[i], dims[i + 1], std=weight), normal(dims[i + 1], std=weight)]
    return his, tgt, valid, params


@pytest.mark.gpu
@pytest.mark.parametrize("scale", ["din", "spread"])
@pytest.mark.parametrize("b,n,s,e,hidden,activation", CASES)
def test_kernel_matches_plain(b, n, s, e, hidden, activation, scale):
    _need_card()
    his, tgt, valid, params = _inputs(b, n, s, e, hidden, scale, seed=b + n + s)
    before = din.din_attention_pool.launches
    got = din.din_attention_pool(his, tgt, valid, params, activation)
    torch.cuda.synchronize()
    assert din.din_attention_pool.launches == before + 1 and tuple(got.shape) == (b, n, e)
    want = din.din_attention_pool_plain(his, tgt, valid, params, activation)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_a_row_with_no_valid_step_gives_nan():
    _need_card()
    his, tgt, valid, params = _inputs(6, 2, 5, 8, (16, 8), "spread", seed=1)
    valid[2] = 0
    got = din.din_attention_pool(his, tgt, valid, params)
    want = din.din_attention_pool_plain(his, tgt, valid, params)
    assert bool(torch.isnan(got[2]).all()) and bool(torch.isnan(want[2]).all())
    keep = [0, 1, 3, 4, 5]
    torch.testing.assert_close(got[keep], want[keep], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", ["din", "spread"])
@pytest.mark.parametrize("b,n,s,e", [(64, 2, 20, 64), (37, 100, 20, 64), (5, 3, 129, 64)])
def test_candidates_equal_to_history_rows(b, n, s, e, scale):
    """Each candidate is one of its row's history rows, so ``h - t`` is exactly
    0 at that step in the concat form, which the split form never forms."""
    _need_card()
    his, tgt, valid, params = _inputs(b, n, s, e, (80, 40), scale, seed=b + s)
    tgt.copy_(his[:, torch.arange(n, device="cuda") % s])
    got = din.din_attention_pool(his, tgt, valid, params)
    want = din.din_attention_pool_plain(his, tgt, valid, params)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", ["din", "spread"])
@pytest.mark.parametrize("b,n,s,e", [(37, 100, 20, 64), (5, 3, 129, 64)])
def test_all_masked_rows_give_nan_at_din_width(b, n, s, e, scale):
    _need_card()
    his, tgt, valid, params = _inputs(b, n, s, e, (80, 40), scale, seed=b * s)
    valid[[0, 2, b - 1]] = 0
    got = din.din_attention_pool(his, tgt, valid, params)
    want = din.din_attention_pool_plain(his, tgt, valid, params)
    masked = torch.zeros(b, dtype=torch.bool, device="cuda")
    masked[[0, 2, b - 1]] = True
    assert bool(torch.isnan(got[masked]).all()) and bool(torch.isnan(want[masked]).all())
    assert not bool(torch.isnan(got[~masked]).any())
    torch.testing.assert_close(got[~masked], want[~masked], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", ["din", "spread"])
def test_function_gradient_matches_plain_autograd(scale):
    """The training shape: the Function launches the kernel once forward and
    none backward, and its gradients equal autograd through the plain
    version."""
    _need_card()
    his, tgt, valid, params = _inputs(4096, 2, 20, 64, (80, 40), scale, seed=7)
    upstream = torch.randn((4096, 2, 64), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (his, tgt, *params)]
        out = fn(leaves[0], leaves[1], valid, leaves[2:])
        out.backward(upstream)
        return out.detach(), [t.grad for t in leaves]

    before = din.din_attention_pool.launches
    got, got_grads = run(din.din_attention_pool)
    torch.cuda.synchronize()
    assert din.din_attention_pool.launches == before + 1
    want, want_grads = run(din.din_attention_pool_plain)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("e,s,hidden", [(64, 20, (80, 40)), (8, 1, (160, 40)), (40, 129, (80, 40)),
                                        (16, 20, (150, 40)), (5, 7, (12, 3, 9)), (64, 20, (1,))])
def test_the_planner_lays_out_the_kernels_shared_memory(e, s, hidden):
    """``smem_bytes`` (plain Python, which picks the rows a tile) gives the
    bytes the kernel's own plan gives at every row count it takes, and the
    kernel refuses row counts outside 1 to a chunk's worth."""
    _need_card()
    lib = din._kernel()
    dims = (ctypes.c_int * (len(hidden) + 2))(4 * e, *hidden, 1)
    most = din.CHUNK // s if s < din.CHUNK else 1
    for rows in range(1, most + 1):
        assert lib.din_attention_smem_bytes(e, s, dims, len(hidden) + 1, rows) == \
            din.smem_bytes(e, s, hidden, rows)
    for rows in (0, most + 1):
        assert lib.din_attention_smem_bytes(e, s, dims, len(hidden) + 1, rows) == -1


@pytest.mark.gpu
def test_empty_batch_launches_nothing_and_bad_widths_raise():
    _need_card()
    before = din.din_attention_pool.launches
    his, tgt, valid, params = _inputs(0, 2, 5, 8, (16, 8), "din", seed=2)
    assert din.din_attention_pool(his, tgt, valid, params).shape == (0, 2, 8)
    assert din.din_attention_pool.launches == before
    his, tgt, valid, params = _inputs(4, 2, 5, 8, (256,), "din", seed=3)
    with pytest.raises(ValueError):  # more shared memory than a block may have
        din.din_attention_pool(his, tgt, valid, params)
    his, tgt, valid, params = _inputs(4, 2, 5, 8, (8,) * 8, "din", seed=4)
    with pytest.raises(ValueError):  # deeper than its 7 hidden layers
        din.din_attention_pool(his, tgt, valid, params)
    with pytest.raises(ValueError):  # a CPU tensor beside CUDA ones
        din.din_attention_pool(his.cpu(), tgt, valid, params)
