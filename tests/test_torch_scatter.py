"""The port's row scatter-set against the JAX package's, on the CPU.

The same numpy table, rows and ids go through ``dma_scatter_set`` (interpret
mode) and the port's ``scatter_set_rows``, which on CPU tensors runs the
plain version, in place, at every row width of the main paths. Ids are
routed as the packed update routes them: each sorted segment's last slot
keeps its id, the others go to ``V + slot`` and drop. Bit-exact: nothing is
computed. ``scatter_plan``, the kernel's lanes and units for a row width
and the rows' addresses, is checked here too: the card's kernel runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.kernels.dma_scatter import dma_scatter_set
from pytorchrec_tpu_torch.ops.kernels.scatter import (
    MAX_LANE_UNITS,
    MAX_LANES,
    THREADS,
    UNITS,
    scatter_plan,
    scatter_set_rows,
)


def _safe_ids(rng, v, n):
    ids = np.sort(rng.integers(0, v, size=n)).astype(np.int32)
    is_last = np.concatenate([ids[1:] != ids[:-1], [True]])
    return np.where(is_last, ids, v + np.arange(n)).astype(np.int32)


def _arrays(rng, dtype, v, n, w):
    if dtype is np.uint8:
        return (rng.integers(0, 255, size=(v, w)).astype(dtype),
                rng.integers(0, 255, size=(n, w)).astype(dtype))
    return rng.normal(size=(v, w)).astype(dtype), rng.normal(size=(n, w)).astype(dtype)


# the main paths' rows: f32 4 B (scales, rowwise accumulators), 16 B, 64 B
# (per-field tables), 96 B and 256 B (packed); u8 16 B (classic int8),
# 128 B, 192 B (byte rows) and 384 B (DIN int8); odd widths
@pytest.mark.parametrize("dtype,w", [(np.float32, 64), (np.float32, 24), (np.uint8, 128),
                                     (np.uint8, 13), (np.float32, 1), (np.float32, 4),
                                     (np.float32, 16), (np.uint8, 16), (np.uint8, 192),
                                     (np.uint8, 384)])
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


# (row bytes, the addresses' alignment): the main paths' rows at 16-byte
# aligned addresses, odd widths, and tables at byte offsets 8, 4, 2 and 1
PLAN_CASES = [(4, 256), (16, 256), (64, 256), (128, 256), (192, 256), (256, 256), (384, 256),
              (1024, 256), (96, 256), (52, 256), (7, 256), (12, 256), (2400, 256), (4096, 256),
              (16, 8), (16, 4), (256, 4), (16, 2), (16, 1), (52, 4), (384, 1), (1, 1)]


@pytest.mark.parametrize("row_bytes,alignment", PLAN_CASES)
def test_scatter_plan(row_bytes, alignment):
    plan = scatter_plan(row_bytes, alignment)
    # the widest unit that divides the row and both addresses
    assert row_bytes % plan.unit == 0 and alignment % plan.unit == 0
    assert all(row_bytes % u or alignment % u for u in UNITS if u > plan.unit)
    assert plan.units * plan.unit == row_bytes
    # lanes: a power of two up to 32, every unit covered (lane l copies units
    # l, l + lanes, ...), no lane without one
    assert plan.lanes & (plan.lanes - 1) == 0 and 1 <= plan.lanes <= MAX_LANES
    assert plan.lane_units == -(-plan.units // plan.lanes)
    assert plan.lanes <= plan.units
    largest = plan.units & -plan.units  # the largest power of two dividing the units
    if plan.units // largest <= MAX_LANE_UNITS or largest >= MAX_LANES:
        assert plan.units % plan.lanes == 0  # no lane idles
        assert plan.lanes == min(largest, MAX_LANES)
    else:
        assert plan.lane_units <= MAX_LANE_UNITS or plan.lanes == MAX_LANES
    assert plan.lanes * plan.groups == THREADS
    assert plan.group_rows == (4 if plan.lane_units == 1 else
                               2 if plan.lane_units <= MAX_LANE_UNITS else 1)
    assert plan.block_slots == plan.groups * plan.group_rows
    if row_bytes in (4, 16) and alignment % 16 == 0:
        assert (plan.lanes, plan.lane_units, plan.group_rows) == (1, 1, 4)  # a thread a row


@pytest.mark.parametrize("row_bytes,lanes,lane_units", [(64, 4, 1), (128, 8, 1), (192, 4, 3),
                                                        (256, 16, 1), (384, 8, 3),
                                                        (1024, 32, 2)])
def test_scatter_plan_at_main_path_widths(row_bytes, lanes, lane_units):
    plan = scatter_plan(row_bytes, 0)
    assert (plan.unit, plan.lanes, plan.lane_units) == (16, lanes, lane_units)


def test_scatter_plan_rejects_empty_rows():
    with pytest.raises(ValueError):
        scatter_plan(0, 16)
