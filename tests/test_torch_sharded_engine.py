"""The port's all-to-all engine (``parallel/embedding_engine.py``), over
gloo on a (2, 2) world, against JAX's functions in ``shard_map`` on the
first four devices of its 8-device CPU mesh, on the same ids, grads and
tables: every rank's output equal to its device's, bit for bit (the
routing is data movement; the two-hop exchange's between-hop sums run the
segmented scan over the same entries in the same order). The cases mirror
``tests/test_sharded_trainer.py``: the lookup's and the row-gradient
exchange's bucket capacities 1, 3, 2.0 and None on ids skewed onto one
owner (capacity 1, 3 and 2.0 overflow: the fallback round and the
all_gather appendix run), the grid's lookup and exchange at capacity 1 and
None, the two-hop exchange and lookup at ``capacity2`` None, 4 and 1.5 on
duplicate-heavy ids, packed rows sliced to ``out_cols``; the whole-array
``make_sharded_lookup`` (both strategies) and ``make_hot_cold_lookup``,
against JAX's and the dense gather. Also the routing
plan against JAX's ``_route_owners``, the capacity resolution, the
received grads against the dense scatter-add, and the hot/cold layout
functions against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_workers as MW
import torch_sharded_workers as W
from pytorchrec_tpu.parallel import embedding_engine as jax_engine
from pytorchrec_tpu.parallel import hot_cold as jax_hot_cold
from pytorchrec_tpu.parallel import make_mesh as jax_make_mesh
from pytorchrec_tpu_torch.parallel import embedding_engine, hot_cold

D, M = 2, 2
AX = ("data", "model")
E = 4


def _skewed(rng, n, hot_rows, v):
    """Ids mostly owned by shard 0 (rows below ``hot_rows``): overflow."""
    return np.concatenate([rng.integers(0, hot_rows, size=n - 4),
                           rng.integers(hot_rows, v, size=4)]).astype(np.int32)


def _duplicates(rng, n, v):
    """Half the ids from a 6-row set: the two-hop combine fires."""
    ids = np.concatenate([rng.integers(0, 6, size=n // 2), rng.integers(0, v, size=n - n // 2)])
    return rng.permutation(ids).astype(np.int32)


def _cases():
    rng = np.random.default_rng(0)
    cases = {}
    v1 = 32  # 16 rows a model shard
    table1 = rng.normal(size=(v1, E)).astype(np.float32)
    wide1 = rng.normal(size=(v1, 2 * E)).astype(np.float32)
    ids1 = _skewed(rng, 16, 16, v1)
    grads1 = rng.normal(size=(16, E)).astype(np.float32)
    for cap in (1, 3, 2.0, None):
        cases[f"lookup-{cap}"] = dict(fn="lookup", table=table1, ids=ids1, capacity=cap)
        cases[f"rowgrad-{cap}"] = dict(fn="rowgrad", ids=ids1, grads=grads1, rows_per_shard=16,
                                       capacity=cap)
    cases["lookup-out_cols"] = dict(fn="lookup", table=wide1, ids=ids1, capacity=1, out_cols=E)
    v2 = 64  # 16 rows a rank of the grid
    table2 = rng.normal(size=(v2, E)).astype(np.float32)
    ids2 = _skewed(rng, 32, 16, v2)
    grads2 = rng.normal(size=(32, E)).astype(np.float32)
    for cap in (1, None):
        cases[f"grid_lookup-{cap}"] = dict(fn="grid_lookup", table=table2, ids=ids2,
                                           capacity=cap)
        cases[f"grid_rowgrad-{cap}"] = dict(fn="grid_rowgrad", ids=ids2, grads=grads2,
                                            rows_per_shard=16, capacity=cap)
    wide2 = rng.normal(size=(v2, 2 * E)).astype(np.float32)
    ids3 = _duplicates(rng, 48, v2)
    grads3 = rng.normal(size=(48, E)).astype(np.float32)
    for cap in (None, 4, 1.5):
        cases[f"two_hop_rowgrad-{cap}"] = dict(fn="two_hop_rowgrad", ids=ids3, grads=grads3,
                                               rows_per_shard=16, capacity=cap)
        cases[f"two_hop_lookup-{cap}"] = dict(fn="two_hop_lookup", table=wide2, ids=ids3,
                                              capacity=cap, out_cols=E)
    for strategy in ("psum", "all_to_all"):
        cases[f"make_sharded_lookup-{strategy}"] = dict(fn="make_sharded_lookup", table=table1,
                                                       ids=ids1, strategy=strategy)
    layout = hot_cold.build_layout(rng.zipf(1.5, size=v1).astype(np.float64), 8, M)
    hot, cold = (t.numpy() for t in hot_cold.split_table(table1, layout))
    cases["make_hot_cold_lookup"] = dict(fn="make_hot_cold_lookup", hot=hot, cold=cold,
                                         perm=layout.perm, ids=ids1, table=table1)
    return cases


CASES = _cases()


def _jax_case(case, mesh):
    """The JAX function in ``shard_map``: each device's outputs, stacked in
    device order ``[d * m, ...]``."""
    fn, cap, oc = case["fn"], case.get("capacity"), case.get("out_cols")
    rows = case.get("rows_per_shard")
    if fn.startswith("make_"):  # whole arrays in and out: each rank holds the whole result
        if fn == "make_sharded_lookup":
            out = jax_engine.make_sharded_lookup(mesh, case["strategy"])(
                jnp.asarray(case["table"]), jnp.asarray(case["ids"]))
        else:
            out = jax_hot_cold.make_hot_cold_lookup(mesh)(
                *(jnp.asarray(case[k]) for k in ("hot", "cold", "perm", "ids")))
        return [np.stack([np.asarray(out)] * (D * M))]
    if fn in ("lookup", "grid_lookup", "two_hop_lookup"):
        table_axis = "model" if fn == "lookup" else AX

        def body(table, ids):
            if fn == "lookup":
                out = jax_engine.all_to_all_lookup(table, ids, "model", capacity=cap,
                                                   out_cols=oc)
            elif fn == "grid_lookup":
                out = jax_engine.grid_lookup(table, ids, AX, capacity=cap, out_cols=oc)
            else:
                out = jax_engine.two_hop_lookup(table, ids, AX, capacity2=cap, out_cols=oc)
            return (out[None],)

        f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(table_axis, None), P("data")),
                                  out_specs=(P(AX),), check_vma=False))
        outs = f(jnp.asarray(case["table"]), jnp.asarray(case["ids"]))
    else:
        def body(ids, grads):
            if fn == "rowgrad":
                r = jax_engine.all_to_all_rowgrad(ids, grads, rows, "model", capacity=cap)
            elif fn == "grid_rowgrad":
                r = jax_engine.grid_rowgrad(ids, grads, rows, AX, capacity=cap)
            else:
                r = jax_engine.two_hop_rowgrad(ids, grads, rows, AX, capacity2=cap)
            return tuple(x[None] for x in r)

        f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("data"), P("data", None)),
                                  out_specs=(P(AX), P(AX)), check_vma=False))
        outs = f(jnp.asarray(case["ids"]), jnp.asarray(case["grads"]))
    return [np.asarray(o) for o in outs]


@pytest.fixture(scope="module")
def engine_results(tmp_path_factory):
    """Every case on the port's (2, 2) world (one world for all) and on
    JAX's mesh, once a test run (``shared_result``)."""
    def compute():
        tmp = tmp_path_factory.mktemp("engine")
        torch.save({"mesh": (D, M), "cases": CASES}, tmp / "inputs.pt")
        ranks = MW.run_world(W.engine_rank, D * M, tmp)
        mesh = jax_make_mesh(data=D, model=M, devices=jax.devices()[:D * M])
        return ranks, {name: _jax_case(case, mesh) for name, case in CASES.items()}

    return W.shared_result(tmp_path_factory, "sharded_engine", compute)


@pytest.mark.parametrize("name", sorted(CASES))
def test_exchange_matches_jax_bit_for_bit(engine_results, name):
    """Each rank's outputs (ids, grads or rows) equal JAX's device's."""
    ranks, jax_out = engine_results
    for rank, result in enumerate(ranks):
        got = result[name]
        assert len(got) == len(jax_out[name]), name
        for g, w in zip(got, jax_out[name]):
            assert g.shape == w[rank].shape and g.dtype == w[rank].dtype, (name, rank)
            np.testing.assert_array_equal(g, w[rank], err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("name", sorted(n for n in CASES if n.startswith("make_")))
def test_whole_array_lookups_gather_the_table(engine_results, name):
    """``make_sharded_lookup`` (both strategies) and ``make_hot_cold_lookup``
    give every rank the whole table's rows at the whole batch's ids."""
    ranks, _ = engine_results
    case = CASES[name]
    for result in ranks:
        np.testing.assert_array_equal(result[name][0], case["table"][case["ids"]])


@pytest.mark.parametrize("name", sorted(n for n in CASES if "rowgrad" in n))
def test_received_grads_sum_to_the_dense_scatter_add(engine_results, name):
    """Every non-sentinel id lands on its owner; the received grads sum to
    the dense scatter-add (rtol 1e-5: bucket and appendix add in another
    order than the reference's)."""
    ranks, _ = engine_results
    case = CASES[name]
    rows = case["rows_per_shard"]
    v = rows * (M if case["fn"] == "rowgrad" else D * M)
    dense = np.zeros((v, E), np.float32)
    np.add.at(dense, case["ids"], case["grads"])
    received = np.zeros((v, E), np.float32)
    for rank, result in enumerate(ranks):
        ids, grads = result[name]
        owner = rank % M if case["fn"] == "rowgrad" else rank
        real = ids < v
        assert np.all(grads[~real] == 0.0)
        assert np.all(ids[real] // rows == owner)
        np.add.at(received, ids[real], grads[real])
    np.testing.assert_allclose(received, dense, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [1, 2, 5])
def test_routing_plan_matches_jax(m):
    """``_route_owners``: the stable order, the positions within each
    bucket and the inverse equal JAX's one-hot cumulative sum's."""
    owner = np.random.default_rng(m).integers(0, m, size=57).astype(np.int32)
    got = embedding_engine._route_owners(torch.from_numpy(owner), m)
    want = jax_engine._route_owners(jnp.asarray(owner), m)
    for field in ("order", "inverse", "sorted_owner", "pos_in_bucket"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)


@pytest.mark.parametrize("args", [(100, 4, 2.0), (7, 8, 2.0), (64, 2, 1.5), (1, 3, 0.1)])
def test_bucket_capacity_matches_jax(args):
    assert embedding_engine.bucket_capacity(*args) == jax_engine.bucket_capacity(*args)
    for capacity in (None, 3, 2.0):
        assert (embedding_engine._resolve_capacity(capacity, *args[:2])
                == jax_engine._resolve_capacity(capacity, *args[:2]))


def test_hot_cold_layout_matches_jax():
    """``build_layout``, ``split_table`` and ``merge_table`` equal JAX's
    (the port's split and merge on tensors), and merging a split gives the
    table back, u8 byte rows too."""
    rng = np.random.default_rng(5)
    counts = rng.zipf(1.5, size=90).astype(np.float64)
    table = rng.normal(size=(90, 3)).astype(np.float32)
    for hot_rows, pad in ((10, 4), (0, 1), (89, 2)):
        got = hot_cold.build_layout(counts, hot_rows, pad)
        want = jax_hot_cold.build_layout(counts, hot_rows, pad)
        np.testing.assert_array_equal(got.perm, want.perm)
        np.testing.assert_array_equal(got.inverse, want.inverse)
        assert (got.hot_rows, got.cold_rows) == (want.hot_rows, want.cold_rows)
        for g, w in zip(hot_cold.split_table(table, got), jax_hot_cold.split_table(table, want)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(hot_cold.merge_table(*hot_cold.split_table(table, got),
                                                           got), table)
        rows = torch.from_numpy(table).view(torch.uint8)
        assert torch.equal(hot_cold.merge_table(*hot_cold.split_table(rows, got), got), rows)
