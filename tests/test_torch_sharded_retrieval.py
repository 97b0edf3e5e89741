"""Corpus-sharded retrieval (``serving/retrieval.py::shard_item_index``,
``make_sharded_retrieve_fn``) over gloo on the CPU, against JAX's on the
first ``d * m`` devices of its 8-device CPU mesh and against the port's
single-device ``make_retrieve_fn``.

JAX's three cases (``tests/test_sharded_retrieval.py:42-62``) at (2, 2):
``("model", 700)`` (350 rows a shard), ``("model", 704)`` and
``(("data", "model"), 700)`` (the whole mesh, the queries on every rank),
and a ragged ``(1, 3)``: 700 items over 3 shards, padded to 702. Every rank
passes the same 16 queries and gets the whole result, k=10:

* exact (chunks of 128 items): ids equal to JAX's sharded function and to
  the port's single-device exact path (chunks of 256), scores within rtol
  1e-5;
* fused (B7's plain version on the CPU, one chunk a super-chunk): ids equal
  to JAX's sharded fused function (the same bins a shard), scores within
  rtol 1e-5, no id past the corpus;
* under ``"model"`` each rank's user tower scored only its data slice of the
  queries (8 of 16), under the whole mesh all 16.

The model and index are JAX's (``_make_model(normalize=False, emb_size=16)``,
an f32 index), the weights through ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import torch_mesh_workers as MW
import torch_sharded_workers as W
from pytorchrec_tpu.feature_column import CategoricalColumnWithIdentity as JaxCategorical
from pytorchrec_tpu.parallel import make_mesh as jax_make_mesh
from pytorchrec_tpu.serving.retrieval import build_item_index as jax_build_item_index
from pytorchrec_tpu.serving.retrieval import make_sharded_retrieve_fn as jax_sharded_retrieve_fn
from pytorchrec_tpu.serving.retrieval import shard_item_index as jax_shard_item_index
from pytorchrec_tpu_torch.parallel import Mesh
from pytorchrec_tpu_torch.serving import make_retrieve_fn, shard_item_index

K, QUERIES = 10, 16
# mesh -> {case: (corpus_axis, n_items)}
WORLDS = {
    (2, 2): {"model_700": ("model", 700), "model_704": ("model", 704),
             "whole_mesh_700": (("data", "model"), 700)},
    (1, 3): {"ragged_700": ("model", 700)},
}


def jax_model(n_items: int):
    from pytorchrec_tpu.models import TwoTower

    return TwoTower(uid_column=JaxCategorical(feature_name="uid", category_num=50),
                    iid_column=JaxCategorical(feature_name="iid", category_num=n_items),
                    label_column=JaxCategorical(feature_name="label", category_num=2),
                    emb_size=16, layers=(16, 8), normalize=False)


def jax_case(mesh_shape, corpus_axis, n_items: int) -> dict:
    """JAX's model, f32 index and sharded exact and fused results."""
    model = jax_model(n_items)
    batch = {"uid": jnp.arange(8), "iid": jnp.zeros((8,), jnp.int32)}
    params = model.init(jax.random.PRNGKey(0), batch, False)
    index = jax_build_item_index(model, params, num_items=n_items, batch_size=128,
                                 dtype=jnp.float32)
    d, m = mesh_shape
    mesh = jax_make_mesh(data=d, model=m, devices=jax.devices()[:d * m])
    sharded = jax_shard_item_index(index, mesh, corpus_axis)
    out = {"index": np.asarray(index), "corpus_axis": corpus_axis, "n_items": n_items,
           "leaves": {k: np.asarray(v) for k, v in
                      traverse_util.flatten_dict(jax.device_get(params["params"]),
                                                 sep="/").items()}}
    for mode, kwargs in (("exact", dict(chunk_items=128)),
                         ("fused", dict(approx="fused", fused_group=1))):
        retrieve = jax_sharded_retrieve_fn(model, mesh, num_items=n_items,
                                           corpus_axis=corpus_axis, **kwargs)
        s, i = retrieve(params, sharded, jnp.arange(QUERIES), K)
        out[mode] = (np.asarray(s), np.asarray(i))
    return out


@pytest.mark.parametrize("mesh_shape", sorted(WORLDS))
def test_sharded_retrieval_matches_jax_and_one_device(mesh_shape, tmp_path):
    cases = {name: jax_case(mesh_shape, *case) for name, case in WORLDS[mesh_shape].items()}
    inputs = {"mesh": mesh_shape, "k": K, "uids": np.arange(QUERIES),
              "cases": {name: {k: c[k] for k in ("index", "corpus_axis", "n_items", "leaves")}
                        for name, c in cases.items()}}
    torch.save(inputs, tmp_path / "inputs.pt")
    ranks = MW.run_world(W.retrieval_rank, mesh_shape[0] * mesh_shape[1], tmp_path)
    for name, want in cases.items():
        n_items, corpus_axis = want["n_items"], want["corpus_axis"]
        model = W.params_from_jax(want["leaves"], W.retrieval_model(n_items))
        s_one, i_one = make_retrieve_fn(model, chunk_items=256)(
            torch.from_numpy(np.array(want["index"])), torch.arange(QUERIES), K)
        whole = corpus_axis != "model"
        for rank, result in enumerate(ranks):
            got = result[name]
            tag = f"{name} rank {rank}"
            for mode in ("exact", "fused"):
                s, i = got[mode]
                assert s.shape == i.shape == (QUERIES, K) and i.dtype == np.int32, (tag, mode)
                assert i.min() >= 0 and i.max() < n_items, (tag, mode)
                np.testing.assert_array_equal(i, want[mode][1], err_msg=f"{tag} {mode}")
                np.testing.assert_allclose(s, want[mode][0], rtol=1e-5, err_msg=f"{tag} {mode}")
            np.testing.assert_array_equal(got["exact"][1], i_one.numpy(), err_msg=tag)
            np.testing.assert_allclose(got["exact"][0], s_one.numpy(), rtol=1e-5, err_msg=tag)
            # the user tower a call: this rank's data slice under "model", else every query
            slice_rows = QUERIES if whole else QUERIES // mesh_shape[0]
            assert got["scored"] == [slice_rows, slice_rows], (tag, got["scored"])
        shards = np.concatenate([r[name]["shard"] for r in ranks[:mesh_shape[1]]] if not whole
                                else [r[name]["shard"] for r in ranks])
        padded = np.zeros((shards.shape[0], want["index"].shape[1]), np.float32)
        padded[:n_items] = want["index"]
        np.testing.assert_array_equal(shards, padded, err_msg=name)


@pytest.mark.parametrize("corpus_axis,rank,rows", [
    ("model", 0, (0, 500)), ("model", 3, (500, 1000)), ("model", 4, (0, 500)),
    (("data", "model"), 5, (625, 750)), (("data", "model"), 7, (875, 1000)),
])
def test_shard_item_index_keeps_the_ranks_rows(corpus_axis, rank, rows):
    """On a (4, 2) mesh, 1000 items: under ``"model"`` a rank keeps its model
    index's half, under the whole mesh its rank's eighth (row-major, as
    JAX's ``PartitionSpec(("data", "model"))`` places them)."""
    index = torch.arange(1000 * 2, dtype=torch.float32).reshape(1000, 2)
    mesh = Mesh(data=4, model=2, rank=rank, device=torch.device("cpu"))
    shard = shard_item_index(index, mesh, corpus_axis)
    torch.testing.assert_close(shard, index[rows[0]:rows[1]], rtol=0, atol=0)


def test_shard_item_index_pads_with_zero_rows_and_refuses_other_axes():
    """701 items over 4 shards: 176 rows each, the last shard's 3 pad rows
    zero; a corpus axis the mesh lacks raises."""
    index = torch.ones((701, 3))
    last = shard_item_index(index, Mesh(data=1, model=4, rank=3, device=torch.device("cpu")))
    assert last.shape == (176, 3)
    assert bool((last[:-3] == 1).all()) and bool((last[-3:] == 0).all())
    mesh = Mesh(data=2, model=2, rank=0, device=torch.device("cpu"))
    for axis in ("corpus", ("model", "model"), ()):
        with pytest.raises(ValueError):
            shard_item_index(index, mesh, axis)
