"""The fused retrieval score + bin-max kernel against its plain version, on
the card.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_retrieval_gpu.py

Inputs are unit rows, as the normalized towers give them, so scores are
cosines. Tolerance: vals rtol 1e-4 / atol 1e-6 (f32 sums of D products in
another order; bf16 products are exact in f32). idx equal wherever a bin's best and
runner-up scores differ by more than that tolerance; where they do not, the
kernel's id must lie in the same bin and score within it.
"""

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch.ops.kernels import retrieval_topk as rt

RTOL, ATOL = 1e-4, 1e-6
# (B, V, D, tc, group, dtype)
CASES = [
    (37, 1024, 16, 256, 2, torch.float32),  # tests/test_pallas_kernels.py's three
    (37, 1000, 16, 256, 2, torch.float32),
    (37, 700, 16, 256, 4, torch.float32),
    (37, 1024, 16, 256, 2, torch.bfloat16),
    (37, 1000, 16, 256, 2, torch.bfloat16),
    (37, 700, 16, 256, 4, torch.bfloat16),
    (1, 100_000, 128, 2048, 16, torch.bfloat16),
    (1, 100_000, 128, 2048, 16, torch.float32),
    (200, 1, 128, 2048, 16, torch.bfloat16),  # one valid id, the rest pad-only bins
    (200, 100, 128, 2048, 16, torch.float32),
    (300, 70_000, 64, 2048, 4, torch.bfloat16),
    (129, 5000, 24, 256, 3, torch.bfloat16),  # depth padded to 32
    (65, 5000, 37, 128, 5, torch.float32),  # element loads, depth padded to 40
    (130, 3000, 200, 512, 2, torch.bfloat16),
    (64, 3000, 152, 512, 2, torch.float32),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d))
    return torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))


def _inputs(b, v, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return _unit_rows(rng, b, d).cuda(), _unit_rows(rng, v, d).cuda().to(dtype)


def _margins(q, items, tc, group):
    """Each bin's best minus its runner-up score (inf where a bin has one
    candidate), in f32 from the plain version's scores."""
    sup = tc * group
    qf = q.to(items.dtype).float()
    out = []
    for start in range(0, items.shape[0], sup):
        scores = qf @ items[start:start + sup].float().T
        scores = torch.nn.functional.pad(scores, (0, sup - scores.shape[1]), value=rt.PAD_SCORE)
        scores = scores.reshape(q.shape[0], sup // rt.LANES, rt.LANES)
        if scores.shape[1] == 1:
            out.append(torch.full_like(scores[:, 0], float("inf")))
        else:
            top = scores.topk(2, dim=1).values
            out.append(top[:, 0] - top[:, 1])
    return torch.cat(out, dim=1)


def assert_bins_agree(q, items, tc, group, got, want):
    """vals within tolerance; idx equal except in near-tied bins, where the
    kernel's id is in the bin and scores within tolerance of its best."""
    (gv, gi), (wv, wi) = got, want
    torch.testing.assert_close(gv, wv, rtol=RTOL, atol=ATOL)
    tied = _margins(q, items, tc, group) <= ATOL + RTOL * wv.abs()
    assert torch.equal(gi[~tied], wi[~tied])
    if tied.any():
        assert torch.equal(gi[tied] % rt.LANES, wi[tied] % rt.LANES)
        assert torch.equal(gi[tied] // (tc * group), wi[tied] // (tc * group))
    return int(tied.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("b,v,d,tc,group,dtype", CASES)
def test_kernel_matches_plain(b, v, d, tc, group, dtype):
    _need_card()
    q, items = _inputs(b, v, d, dtype, seed=b + v + d)
    before = rt.bin_max_scores.launches
    got = rt.bin_max_scores(q, items, tc, group)
    torch.cuda.synchronize()
    assert rt.bin_max_scores.launches == before + 1
    n_super = -(-v // (tc * group))
    assert got[0].shape == got[1].shape == (b, n_super * rt.LANES)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_bins_agree(q, items, tc, group, got, rt.bin_max_scores_plain(q, items, tc, group))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_serving_shape(dtype):
    """4096 queries x 1,000,000 items, D=128, the default tc and group: 31
    super-chunks, the last one partial."""
    _need_card()
    q, items = _inputs(4096, 1_000_000, 128, dtype, seed=5)
    got = rt.bin_max_scores(q, items)
    want = rt.bin_max_scores_plain(q, items)
    tied = assert_bins_agree(q, items, rt.DEFAULT_TC, rt.DEFAULT_GROUP, got, want)
    assert tied < got[0].numel() // 1000  # about 0.08% of the bins of unit rows tie so closely


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_duplicated_rows_give_the_lowest_id(dtype):
    """items[i] == items[i + 128]: equal scores in a bin go to the lower id."""
    _need_card()
    q, items = _inputs(50, 4096, 32, dtype, seed=3)
    items[128:256] = items[:128]
    items[600 + 128] = items[600]
    got_vals, got_idx = rt.bin_max_scores(q, items, 256, 4)
    want_vals, want_idx = rt.bin_max_scores_plain(q, items, 256, 4)
    torch.testing.assert_close(got_vals, want_vals, rtol=RTOL, atol=ATOL)
    assert torch.equal(got_idx, want_idx)
    assert not bool((got_idx // 128 == 1).any())  # rows 128..255 never win over 0..127


@pytest.mark.gpu
def test_empty_inputs_launch_nothing_and_bad_inputs_raise():
    _need_card()
    before = rt.bin_max_scores.launches
    q, items = _inputs(0, 500, 16, torch.bfloat16, seed=1)
    vals, idx = rt.bin_max_scores(q, items)
    assert vals.shape == idx.shape == (0, rt.LANES) and rt.bin_max_scores.launches == before
    q, items = _inputs(4, 500, 256, torch.bfloat16, seed=1)
    with pytest.raises(ValueError):  # more shared memory than a block may have
        rt.bin_max_scores(q, items)
    with pytest.raises(TypeError):
        rt.bin_max_scores(q, items.half())
    with pytest.raises(ValueError):
        rt.bin_max_scores(q[:, :128], items[:, ::2])
    with pytest.raises(ValueError):  # a CPU tensor beside a CUDA one
        rt.bin_max_scores(q.cpu(), items)
