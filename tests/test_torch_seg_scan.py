"""The port's segmented sum scan against the JAX package's, on the CPU.

The same numpy rows and heads go through ``segmented_sum_scan_pallas``
(interpret mode, 8-row blocks), the XLA twin ``_segmented_sum_scan`` and the
port's ``segmented_sum_scan``, which on CPU tensors runs the plain version.
Tolerance rtol 1e-5 / atol 1e-5, as the JAX package's own kernel test: the
sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.kernels.seg_scan import segmented_sum_scan_pallas
from pytorchrec_tpu.ops.sparse_update import _segmented_sum_scan
from pytorchrec_tpu_torch.ops.kernels.seg_scan import (
    scan_vector_width,
    segmented_sum_scan,
    segmented_sum_scan_plain,
)

RTOL, ATOL = 1e-5, 1e-5


def _heads(rng, n, long_runs):
    heads = rng.random(n) < 0.3
    if long_runs and n > 30:
        heads[3:3 + 13] = False   # a run of 14 rows crossing two 8-row blocks
        heads[20:20 + min(n - 21, 60)] = False  # longer than several blocks
    heads[0] = True
    return heads


@pytest.mark.parametrize("long_runs", [False, True])
@pytest.mark.parametrize("e", [1, 4, 16])
@pytest.mark.parametrize("n", [1, 7, 37, 300])
def test_plain_scan_matches_pallas_and_xla(n, e, long_runs):
    rng = np.random.default_rng(n * 100 + e + long_runs)
    x = rng.normal(size=(n, e)).astype(np.float32)
    heads = _heads(rng, n, long_runs)
    before = segmented_sum_scan.launches
    got = segmented_sum_scan(torch.from_numpy(x), torch.from_numpy(heads))
    assert segmented_sum_scan.launches == before  # CPU: the plain version
    assert got.shape == (n, e) and got.dtype == torch.float32 and got.is_contiguous()
    pallas = segmented_sum_scan_pallas(jnp.asarray(x), jnp.asarray(heads), block_rows=8,
                                       interpret=True)
    xla = _segmented_sum_scan(jnp.asarray(x), jnp.asarray(heads))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=RTOL, atol=ATOL)


def test_segment_totals_sit_in_last_rows():
    rng = np.random.default_rng(3)
    ids = np.sort(rng.integers(0, 9, 200))
    x = rng.normal(size=(200, 4)).astype(np.float32)
    heads = np.concatenate([[True], ids[1:] != ids[:-1]])
    out = segmented_sum_scan_plain(torch.from_numpy(x), torch.from_numpy(heads)).numpy()
    last = np.concatenate([ids[1:] != ids[:-1], [True]])
    for i in np.flatnonzero(last):
        np.testing.assert_allclose(out[i], x[ids == ids[i]].sum(axis=0), rtol=1e-5, atol=1e-6)


def test_strided_column_slice_needs_no_copy_of_the_input():
    """The packed update scans a column slice of wider rows."""
    rng = np.random.default_rng(4)
    wide = torch.from_numpy(rng.normal(size=(50, 64)).astype(np.float32))
    heads = torch.from_numpy(_heads(rng, 50, True))
    got = segmented_sum_scan(wide[:, 12:16], heads)
    torch.testing.assert_close(got, segmented_sum_scan(wide[:, 12:16].contiguous(), heads),
                               rtol=0, atol=0)
    assert wide[:, 12:16].stride() == (64, 1)


@pytest.mark.parametrize("x_shape,start_shape,dtype", [
    ((5, 4), (4,), torch.bool),      # lengths differ
    ((5,), (5,), torch.bool),        # x not 2-D
    ((5, 4), (5,), torch.float32),   # flags not bool
])
def test_wrapper_rejects_bad_inputs(x_shape, start_shape, dtype):
    with pytest.raises((ValueError, TypeError)):
        segmented_sum_scan(torch.zeros(x_shape), torch.zeros(start_shape, dtype=dtype))


@pytest.mark.parametrize("address,stride,e,want", [
    (4096 + 192, 64, 16, 4),   # the f32 update's staging slice: 16-byte loads
    (4096 + 24, 32, 16, 2),    # the int8 update's, 24 bytes into 128-byte rows
    (4096 + 12, 64, 1, 1),     # DeepFM's linear table, E=1
    (4096 + 72, 96, 64, 2),    # DIN's int8 rows, 72 bytes into 384-byte rows
    (4096 + 768, 256, 64, 4),  # DIN's f32 rows
    (4096, 300, 300, 4),
    (4096, 257, 257, 1),
    (4096 + 20, 76, 64, 1),    # 4-byte aligned only
    (4096, 66, 64, 2),         # the stride allows no more
])
def test_scan_vector_width(address, stride, e, want):
    """B2's loads: the widest of 4, 2, 1 floats the slice allows."""
    assert scan_vector_width(address, stride, e) == want
