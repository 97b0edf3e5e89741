"""The cross-network CUDA kernel against its plain version, on the card.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_cross_gpu.py

Tolerance rtol 1e-4 / atol 1e-6: the f32 sums of D terms run in another
order in the kernel than in cuBLAS. Batches not a multiple of the kernel's
64-row tile, and D = 1, 429 and 512, reach its edges. The kernel sums each
output in one f32 accumulator in k order; at (1000, 512, 3) cuBLAS sums
more accurately than that, and the kernel misses the tolerance in a few
elements (``ROADMAP.md`` C, "f32 numerics"): that case fails on the card.
"""

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch.ops.kernels.cross import cross_network, cross_network_plain


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("batch,dim,layers", [(1, 429, 3), (1000, 429, 3), (32768, 429, 3),
                                              (37, 37, 3), (65, 8, 1), (33, 512, 2),
                                              (4097, 429, 3), (1000, 512, 2), (1000, 512, 3),
                                              (131, 1, 3), (1, 1, 2), (63, 100, 3), (200, 64, 4)])
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


@pytest.mark.gpu
def test_cross_kernel_raises_past_its_widest_d():
    _need_card()
    for dim in (513, 2048):
        x0 = torch.zeros(4, dim, device="cuda")
        ws = torch.zeros(1, dim, dim, device="cuda")
        bs = torch.zeros(1, dim, device="cuda")
        with pytest.raises(ValueError, match="D <= 512"):
            cross_network(x0, ws, bs)
