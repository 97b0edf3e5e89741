"""The port's mesh (``pytorchrec_tpu_torch/parallel``) on the CPU: its rank
layout and sharding rules against JAX's, ``masked_psum_lookup`` against a
dense gather, the global-norm clip over a sharded table, the preemption
consensus and the ``dryrun_multichip`` twin.

Multi-rank cases spawn gloo ranks (``torch_mesh_workers.run_world``: a
``file://`` store under ``tmp_path``, a 60 s collective timeout, a parent
that kills its children past a deadline); JAX runs in this process only,
on the 8 virtual CPU devices of ``tests/conftest.py``. The rules need no
process group: a ``Mesh`` of plain numbers stands for each rank.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

import torch_mesh_workers as W
from pytorchrec_tpu.feature_column import CategoricalColumnWithIdentity as JaxCategorical
from pytorchrec_tpu.feature_column import NumericColumn as JaxNumeric
from pytorchrec_tpu.models import DCNv2 as JaxDCNv2
from pytorchrec_tpu.models import FunkSVD as JaxFunkSVD
from pytorchrec_tpu.parallel import MODEL_AXIS
from pytorchrec_tpu.parallel import make_mesh as jax_make_mesh
from pytorchrec_tpu.parallel import param_shardings as jax_param_shardings
from pytorchrec_tpu_torch.parallel import (
    DATA_AXIS,
    Mesh,
    RowShard,
    data_sharding,
    make_mesh,
    param_shardings,
    replicated,
    shard_params,
)
from pytorchrec_tpu_torch.training import Trainer

CPU = torch.device("cpu")


def jax_tree(name):
    """A JAX model's parameters, flat by flax path: FunkSVD (63 user rows,
    256 item rows) or DCN-v2 of per-field tables (64, 32, 63 and 2 rows)."""
    label = JaxCategorical(feature_name="label", category_num=2)
    if name == "funk_svd":
        model = JaxFunkSVD(uid_column=JaxCategorical(feature_name="uid", category_num=W.USERS),
                           iid_column=JaxCategorical(feature_name="iid", category_num=W.ITEMS),
                           label_column=label, emb_size=8)
        batch = {"uid": np.zeros(4, np.int32), "iid": np.zeros(4, np.int32)}
    else:
        vocab = {"c_0": 64, "c_1": 32, "c_2": 63, "c_3": 2}
        model = JaxDCNv2(sparse_columns=tuple(JaxCategorical(feature_name=k, category_num=v)
                                              for k, v in vocab.items()),
                         dense_columns=(JaxNumeric(feature_name="d_0"),), label_column=label,
                         emb_size=4, num_cross_layers=2, layers=(8,))
        batch = {**{k: np.zeros(4, np.int32) for k in vocab},
                 "d_0": np.zeros(4, np.float32)}
    params = model.init(jax.random.PRNGKey(0), batch, train=False)["params"]
    flat = traverse_util.flatten_dict(jax.device_get(params), sep="/")
    return params, {k: np.asarray(v) for k, v in flat.items()}


# ---------------------------------------------------------------------------
# the layout and the rules
# ---------------------------------------------------------------------------


def test_make_mesh_places_ranks_as_the_jax_mesh_places_devices(tmp_path):
    grid = np.vectorize(lambda d: d.id)(jax_make_mesh(data=2, model=2,
                                                      devices=jax.devices()[:4]).devices)
    results = W.run_world(W.layout_rank, 4, tmp_path)
    for rank, got in enumerate(results):
        i, j = got["at"]
        assert grid[i, j] == rank
        assert got["model_group"] == list(grid[i])
        assert got["data_group"] == list(grid[:, j])


@pytest.mark.parametrize("name", ["funk_svd", "dcnv2"])
@pytest.mark.parametrize("model", [1, 2, 4])
@pytest.mark.parametrize("min_rows", [0, 40])
def test_param_shardings_match_jax(name, model, min_rows):
    """Each leaf's sharding as JAX's ``param_shardings`` gives it on a mesh
    of the same shape: a table row-sharded over the model axis or
    replicated (63 rows never divide; 2 rows do not reach 4); each rank's
    ``RowShard`` holds its run of rows."""
    params, flat = jax_tree(name)
    jax_mesh = jax_make_mesh(data=8 // model, model=model, devices=jax.devices()[:8])
    want = traverse_util.flatten_dict(
        jax_param_shardings(params, jax_mesh, min_rows_to_shard=min_rows), sep="/")
    leaves = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    for rank in range(8):
        mesh = Mesh(data=8 // model, model=model, rank=rank, device=CPU)
        got = param_shardings(leaves, mesh, min_rows_to_shard=min_rows)
        assert set(got) == set(want)
        for path, spec in got.items():
            if want[path].spec == jax.sharding.PartitionSpec(MODEL_AXIS, None):
                rows = flat[path].shape[0]
                assert spec == RowShard(rows, rows // model,
                                        mesh.model_index * (rows // model)), path
            else:
                assert spec == replicated(mesh), path
        local = shard_params(leaves, mesh, min_rows_to_shard=min_rows)
        for path, spec in got.items():
            if isinstance(spec, RowShard):
                np.testing.assert_array_equal(
                    local[path].numpy(),
                    flat[path][spec.offset:spec.offset + spec.rows_per_shard])
            else:
                assert local[path] is leaves[path]


@pytest.mark.parametrize("data", [1, 2, 4])
def test_data_sharding_keeps_each_data_index_rows(data):
    batch = {"a": np.arange(8), "b": np.arange(16).reshape(8, 2)}
    parts = [data_sharding(Mesh(data=data, model=2, rank=2 * i, device=CPU)).local(batch)
             for i in range(data)]
    for key, value in batch.items():
        np.testing.assert_array_equal(np.concatenate([p[key] for p in parts]), value)
    assert Mesh(data=data, model=2, rank=1, device=CPU).shape == {DATA_AXIS: data, "model": 2}
    with pytest.raises(ValueError, match="split"):
        data_sharding(Mesh(data=3, model=1, rank=0, device=CPU)).local(batch)


def test_a_mesh_needs_an_initialised_world_and_a_trainer_a_mesh():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(data=1, model=1, device="cpu")
    model = W.funk_svd("cpu")
    with pytest.raises(TypeError, match="Mesh"):
        Trainer(model, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="rank device"):
        Trainer(model, device="cpu", mesh=Mesh(data=1, model=1, rank=0,
                                               device=torch.device("cuda", 0)))


# ---------------------------------------------------------------------------
# the lookup and the clip
# ---------------------------------------------------------------------------


def test_masked_psum_lookup_matches_a_dense_gather_and_its_gradient(tmp_path):
    """On a (2, 2) mesh every rank gets the gathered rows; each model
    index's shard gradient is its rows of the dense gradient, once (the
    backward is the identity, not a second sum over the model group)."""
    results = W.run_world(W.lookup_rank, 4, tmp_path)
    table, ids, w = results[0]["table"], results[0]["ids"], results[0]["w"]
    dense = torch.zeros_like(table).index_add_(0, ids, w)
    for got in results:
        assert torch.equal(got["vectors"], table[ids])
    for data_index in range(2):
        shards = [results[2 * data_index + j]["grad"] for j in range(2)]
        torch.testing.assert_close(torch.cat(shards), dense, rtol=0, atol=1e-6)


def test_grad_clip_norm_on_a_sharded_table_matches_one_process(tmp_path):
    """FunkSVD's item table sharded over a model axis of 2, the global-norm
    clip at a norm the gradients pass: the mesh run's state is the one
    process's (rtol 2e-5 / atol 2e-6), a local norm would not be."""
    rng = np.random.default_rng(4)
    inputs = dict(model="funk_svd", trainer="dense", mesh=(1, 2),
                  compile=dict(optimizer="sgd", lr=10.0, loss="bce", grad_clip_norm=1e-3),
                  batches=[W.funk_svd_batch(rng, 16) for _ in range(3)])
    torch.save(inputs, tmp_path / "inputs.pt")
    got = W.run_world(W.train_rank, 2, tmp_path)
    want = W.train(inputs, None, str(tmp_path))
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=2e-5)
    for path, value in want["state"]["params"].items():
        torch.testing.assert_close(got[0]["state"]["params"][path], value, rtol=2e-5,
                                   atol=2e-6)
    for path, moments in want["state"]["opt_state"].items():
        for key, value in moments.items():
            torch.testing.assert_close(got[1]["state"]["opt_state"][path][key], value,
                                       rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# the preemption consensus and the dry run
# ---------------------------------------------------------------------------


def test_preemption_guard_stops_every_rank_at_one_step(tmp_path):
    """Rank 1 alone is flagged after its fifth batch; at the next sync point
    (8 batches, ``sync_every=4``) both ranks save and stop, and rank 0 has
    written the step's checkpoint."""
    rng = np.random.default_rng(5)
    inputs = dict(model="funk_svd", trainer="dense",
                  compile=dict(optimizer="adam", lr=1e-2, loss="bce"),
                  train=W.funk_svd_batch(rng, 16 * 12))
    torch.save(inputs, tmp_path / "inputs.pt")
    results = W.run_world(W.preemption_rank, 2, tmp_path)
    assert [r["step"] for r in results] == [8, 8]
    assert results[0]["files"] == ["8.pt"]
    saved = torch.load(tmp_path / "ckpt" / "8.pt", weights_only=True)
    assert saved["step"] == 8
    assert saved["params"]["i_embeddings/embedding"].shape == (W.ITEMS, 8)


def test_dryrun_multichip_path_one_at_world_four(tmp_path):
    """The port's twin of paths 1 and 7 of
    ``__graft_entry__.dryrun_multichip(4)``: a (2, 2) mesh, one sharded
    DCN-v2 step and one eval step on every rank, then 8 queries at k=5 over
    a 100-item two-tower index sharded over the model axis."""
    results = W.run_world(W.dryrun_rank, 4, tmp_path)
    losses = [r["loss"] for r in results]
    assert all(np.isfinite(losses)) and len(set(losses)) == 1
    assert all(r["shape"] == (16,) for r in results)
    assert all(r["ids_shape"] == (8, 5) for r in results)


# ---------------------------------------------------------------------------
# table_row_multiple: unified tables whose rows divide the model axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["LR", "FM", "DeepFM", "DLRM", "DCNv2"])
def test_table_row_multiple_rounds_the_unified_tables_as_jax(name):
    """Fields of 50, 8 and 200 ids at ``table_row_multiple=4``: the field
    offsets and the rounded row count are JAX's ``_field_offsets``, every
    unified table has 260 rows, and a model axis of 4 shards them."""
    from pytorchrec_tpu import models as jax_models
    from pytorchrec_tpu_torch import models
    from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn

    vocab = {"c_0": 50, "c_1": 8, "c_2": 200}
    kwargs = dict(emb_size=8, unified_embedding=True, table_row_multiple=4)
    want = getattr(jax_models, name)(
        sparse_columns=tuple(JaxCategorical(feature_name=k, category_num=v)
                             for k, v in vocab.items()),
        dense_columns=(JaxNumeric(feature_name="d_0"),),
        label_column=JaxCategorical(feature_name="label", category_num=2), **kwargs)
    model = getattr(models, name)(
        sparse_columns=tuple(CategoricalColumnWithIdentity(feature_name=k, category_num=v)
                             for k, v in vocab.items()),
        dense_columns=(NumericColumn(feature_name="d_0"),), label_column=W.label_column(),
        device="cpu", **kwargs)
    assert model._field_offsets() == want._field_offsets() == ([0, 50, 58], 260)
    tables = {k: p for k, p in model.named_parameters() if k.startswith("unified_")}
    assert tables and all(p.shape[0] == 260 for p in tables.values())
    mesh = Mesh(data=2, model=4, rank=5, device=CPU)
    specs = param_shardings({k.replace(".", "/"): p for k, p in tables.items()}, mesh)
    assert set(specs.values()) == {RowShard(260, 65, 65)}
