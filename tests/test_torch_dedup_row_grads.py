"""``dedup_row_grads`` on the CPU, the port against the JAX package's, on the
same numpy ids and grads: with and without ``pad_id_base``, with no
duplicate, with one id throughout, with one slot, and with Zipf-skewed ids
whose runs are long.

The slots (ids, mask) must be equal. The summed rows agree within rtol 1e-6
/ atol 1e-7: both sum each id's grads in occurrence order, but the port's
segmented scan adds them as a tree and JAX's segment sum one after another.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops import sparse_update as jsu
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.ops.sparse_update import SparseRowGrad, dedup_row_grads

V = 1000


def _ids(kind, n, rng):
    if kind == "unique":
        return rng.permutation(V)[:n].astype(np.int32)
    if kind == "one_id":
        return np.full(n, 7, np.int32)
    return np.minimum(rng.zipf(1.3, n) - 1, V - 1).astype(np.int32)


@pytest.mark.parametrize("pad_id_base", [None, V])
@pytest.mark.parametrize("kind,n", [("zipf", 500), ("unique", 64), ("one_id", 33), ("zipf", 1)])
def test_dedup_matches_jax(kind, n, pad_id_base):
    rng = np.random.default_rng(n)
    ids = _ids(kind, n, rng)
    dvec = rng.standard_normal((n, 4)).astype(np.float32)
    want = jsu.dedup_row_grads(jnp.asarray(ids), jnp.asarray(dvec), pad_id_base=pad_id_base)
    before = segmented_sum_scan.launches
    got = dedup_row_grads(torch.from_numpy(ids), torch.from_numpy(dvec), pad_id_base=pad_id_base)
    assert segmented_sum_scan.launches == before  # the CPU runs the plain scan
    assert isinstance(got, SparseRowGrad)
    assert got.ids.dtype == torch.int32 and got.mask.dtype == torch.float32
    assert tuple(got.rows.shape) == (n, 4)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows), rtol=1e-6, atol=1e-7)
    unique = np.unique(ids)
    assert int(got.mask.sum()) == unique.size
    np.testing.assert_array_equal(got.ids.numpy()[:unique.size], unique)
    assert not got.rows[unique.size:].any()  # padding carries zero rows
    if pad_id_base is None:  # padding aliases the last unique id
        assert (got.ids.numpy()[unique.size:] == unique[-1]).all()
    else:  # out of range, ascending, unique
        np.testing.assert_array_equal(got.ids.numpy()[unique.size:],
                                      pad_id_base + np.arange(unique.size, n))


def test_each_id_gets_the_sum_of_its_grads():
    ids = torch.tensor([5, 2, 5, 9, 2, 5], dtype=torch.int32)
    dvec = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    got = dedup_row_grads(ids, dvec)
    assert got.ids.tolist() == [2, 5, 9, 9, 9, 9]
    assert got.mask.tolist() == [1, 1, 1, 0, 0, 0]
    assert got.rows.tolist() == [[10, 12], [14, 17], [6, 7], [0, 0], [0, 0], [0, 0]]


def test_no_slots():
    got = dedup_row_grads(torch.zeros((0,), dtype=torch.int32), torch.zeros((0, 3)))
    assert got.ids.shape == (0,) and got.rows.shape == (0, 3) and got.mask.shape == (0,)
