"""The port's row scatter-set against the JAX package's, on the CPU.

The same numpy table, rows and ids go through ``dma_scatter_set`` (interpret
mode) and the port's ``scatter_set_rows``, which on CPU tensors runs the
plain version, in place. Ids are routed as the packed update routes them:
each sorted segment's last slot keeps its id, the others go to ``V + slot``
and drop. Bit-exact: nothing is computed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.kernels.dma_scatter import dma_scatter_set
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows


def _safe_ids(rng, v, n):
    ids = np.sort(rng.integers(0, v, size=n)).astype(np.int32)
    is_last = np.concatenate([ids[1:] != ids[:-1], [True]])
    return np.where(is_last, ids, v + np.arange(n)).astype(np.int32)


def _arrays(rng, dtype, v, n, w):
    if dtype is np.uint8:
        return (rng.integers(0, 255, size=(v, w)).astype(dtype),
                rng.integers(0, 255, size=(n, w)).astype(dtype))
    return rng.normal(size=(v, w)).astype(dtype), rng.normal(size=(n, w)).astype(dtype)


@pytest.mark.parametrize("dtype,w", [(np.float32, 64), (np.float32, 24), (np.uint8, 128),
                                     (np.uint8, 13)])
def test_plain_scatter_matches_dma_scatter(dtype, w):
    rng = np.random.default_rng(w)
    v, n = 512, 5000
    table, rows = _arrays(rng, dtype, v, n, w)
    ids = _safe_ids(rng, v, n)
    want = np.asarray(dma_scatter_set(jnp.asarray(table), jnp.asarray(rows), jnp.asarray(ids),
                                      interpret=True))
    port_table = torch.from_numpy(table.copy())
    before = scatter_set_rows.launches
    out = scatter_set_rows(port_table, torch.from_numpy(rows), torch.from_numpy(ids))
    assert scatter_set_rows.launches == before  # CPU: the plain version
    assert out is port_table  # in place
    np.testing.assert_array_equal(port_table.numpy(), want)
    assert (port_table.numpy() != table).any()


def test_all_dropped_leaves_the_table_as_it_was():
    rng = np.random.default_rng(1)
    v, n, w = 64, 100, 32
    table, rows = _arrays(rng, np.float32, v, n, w)
    ids = np.full((n,), v, np.int32)
    want = np.asarray(dma_scatter_set(jnp.asarray(table), jnp.asarray(rows), jnp.asarray(ids),
                                      interpret=True))
    port_table = torch.from_numpy(table.copy())
    scatter_set_rows(port_table, torch.from_numpy(rows), torch.from_numpy(ids))
    np.testing.assert_array_equal(port_table.numpy(), want)
    np.testing.assert_array_equal(port_table.numpy(), table)


def test_negative_ids_drop_too():
    table = torch.zeros(4, 3)
    scatter_set_rows(table, torch.ones(3, 3), torch.tensor([-1, 2, 4], dtype=torch.int32))
    assert torch.equal(table.sum(dim=1), torch.tensor([0.0, 0.0, 3.0, 0.0]))


@pytest.mark.parametrize("table,rows,ids", [
    (torch.zeros(4, 3), torch.zeros(2, 2), torch.zeros(2, dtype=torch.int32)),   # width
    (torch.zeros(4, 3), torch.zeros(2, 3), torch.zeros(3, dtype=torch.int32)),   # count
    (torch.zeros(4, 3), torch.zeros(2, 3, dtype=torch.float64),
     torch.zeros(2, dtype=torch.int32)),                                         # dtype
    (torch.zeros(4, 3), torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64)),   # id dtype
])
def test_wrapper_rejects_bad_inputs(table, rows, ids):
    with pytest.raises((ValueError, TypeError)):
        scatter_set_rows(table, rows, ids)
