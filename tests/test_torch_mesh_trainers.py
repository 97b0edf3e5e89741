"""The port's three table trainers on a mesh, over gloo on the CPU, against
JAX's trainers on a mesh of the same shape and against the port's own
one-process run.

* ``Trainer`` (FunkSVD: its 63-row user table no model axis of 2 divides,
  so it stays whole, its 256-row item table is row-sharded) and
  ``SparseEmbeddingTrainer`` (the unified DCN-v2 of
  ``tests/test_sparse_update.py``, unpacked lazy Adam) at meshes (2, 1),
  (1, 2) and (2, 2) against JAX's trainers on
  ``make_mesh(data, model, devices=jax.devices()[:data * model])``, from
  JAX's initial leaves (``params_from_jax``): each step's loss rtol 1e-5,
  the parameters and the table moments after the steps rtol 1e-4 / atol
  1e-6 (ROADMAP's f32-after-N-steps);
* every run, and the packed f32, byte-row and per-field sparse formats and
  the classic and packed int8 tables of ``QuantizedEmbeddingTrainer``,
  against the port's one-process run of the same inputs at rtol 2e-5 /
  atol 2e-6 (JAX's own bound for mesh against one device,
  ``tests/test_parallel.py:121``): the whole state (weights, dense Adam
  state, table moments or accumulators), the eval split's metrics and
  predictions. The int8 tables train on batches with unique ids, and their
  q bytes equal the one process's byte for byte;
* at (2, 2), a checkpoint and the weights saved and restored on the mesh
  give back the state, and rank 0's file has the one-process layout.
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
from pytorchrec_tpu.parallel import make_mesh as jax_make_mesh
from pytorchrec_tpu.training import Trainer as JaxTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer as JaxSparseTrainer

MESHES = [(2, 1), (1, 2), (2, 2)]
RTOL, ATOL = 2e-5, 2e-6  # mesh against one process
JAX_RTOL, JAX_ATOL = 1e-4, 1e-6  # the port against JAX
EMB = 4  # DCN-v2's table width here


def flat(tree) -> dict:
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def jax_label():
    return JaxCategorical(feature_name="label", category_num=2)


def jax_model(name):
    if name == "funk_svd":
        return JaxFunkSVD(uid_column=JaxCategorical(feature_name="uid", category_num=W.USERS),
                          iid_column=JaxCategorical(feature_name="iid", category_num=W.ITEMS),
                          label_column=jax_label(), emb_size=8)
    return JaxDCNv2(sparse_columns=tuple(JaxCategorical(feature_name=k, category_num=v)
                                         for k, v in W.FIELDS.items()),
                    dense_columns=(JaxNumeric(feature_name="d_0"),), label_column=jax_label(),
                    emb_size=EMB, num_cross_layers=2, layers=(8,), unified_embedding=True)


def jax_run(name, mesh_shape, batches, lr):
    """JAX's trainer on its mesh: the initial leaves, each step's loss, the
    final parameters and table moments."""
    data, model = mesh_shape
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    cls = JaxTrainer if name == "funk_svd" else JaxSparseTrainer
    trainer = cls(jax_model(name), mesh=mesh)
    trainer.compile(optimizer="adam", lr=lr, loss="bce", metrics=("auc",))
    trainer.init_state(batches[0], seed=0)
    leaves = flat(trainer.state.params)
    losses = [float(trainer._train_step(batch)) for batch in batches]
    moments = flat(getattr(trainer.state, "table_moments", {}))
    return leaves, losses, flat(trainer.state.params), moments


def close(got, want, path, rtol=RTOL, atol=ATOL):
    """A state entry against the one process's: f32 values within the
    tolerance; int8 q bytes (a classic ``unified_q``, the first E bytes of
    packed int8 rows) equal, the packed int8 rows' scale and accumulator
    f32 values and byte rows' f32 fields within it."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape and got.dtype == want.dtype, path
    if got.dtype == torch.int8:
        assert torch.equal(got, want), f"{path}: q bytes differ"
    elif got.dtype == torch.uint8 and path.endswith("unified_q"):
        assert torch.equal(got[:, :EMB], want[:, :EMB]), f"{path}: q bytes differ"
        fields = slice(EMB, EMB + 8)  # scale || acc
        torch.testing.assert_close(got[:, fields].contiguous().view(torch.float32),
                                   want[:, fields].contiguous().view(torch.float32),
                                   rtol=rtol, atol=atol, msg=path)
    elif got.dtype == torch.uint8:
        torch.testing.assert_close(got.view(torch.float32), want.view(torch.float32),
                                   rtol=rtol, atol=atol, msg=path)
    else:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=path)


def assert_state_close(got: dict, want: dict, prefix=""):
    assert set(got) == set(want), (prefix, sorted(got), sorted(want))
    for key, value in want.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            assert_state_close(got[key], value, path)
        elif key in ("rng_state", "rng_key", "step"):
            assert np.array_equal(np.asarray(got[key]), np.asarray(value)), path
        else:
            close(got[key], value, path)


def mesh_against_one_process(inputs, tmp_path):
    """Run ``inputs`` on its mesh and in this process; hold every rank's
    result to the one process's. Returns (rank results, one-process
    result)."""
    torch.save(inputs, tmp_path / "inputs.pt")
    data, model = inputs["mesh"]
    results = W.run_world(W.train_rank, data * model, tmp_path)
    (tmp_path / "one").mkdir()
    want = W.train(inputs, None, str(tmp_path / "one"))
    for got in results:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
        assert_state_close(got["state"], want["state"])
        for name, value in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][name], value, rtol=1e-6)
        np.testing.assert_allclose(got["predictions"], want["predictions"], rtol=RTOL, atol=ATOL)
    if inputs.get("save_load"):
        assert all(r["restored"] and r["weights_restored"] for r in results)
        saved = torch.load(tmp_path / "state.pt", weights_only=True)
        layout = {k: tuple(v.shape) for k, v in want["state"]["params"].items()}
        assert {k: tuple(v.shape) for k, v in saved["params"].items()} == layout
        assert set(saved) == set(want["state"])
    return results, want


def against_jax(results, jax_out, paths_moments=()):
    _, losses, params, moments = jax_out
    got = results[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    port = got["state"]["params"]
    for path, value in port.items():
        np.testing.assert_allclose(value.numpy(), params[path], rtol=JAX_RTOL, atol=JAX_ATOL,
                                   err_msg=path)
    for path, value in moments.items():
        table, key = path.rsplit("/", 1)
        np.testing.assert_allclose(got["state"]["table_moments"][table][key].numpy(), value,
                                   rtol=JAX_RTOL, atol=JAX_ATOL, err_msg=path)


@pytest.mark.parametrize("mesh", MESHES)
def test_trainer_on_a_mesh_matches_jax_and_one_process(mesh, tmp_path):
    rng = np.random.default_rng(1)
    batches = [W.funk_svd_batch(rng, 16) for _ in range(3)]
    jax_out = jax_run("funk_svd", mesh, batches, lr=1e-2)
    inputs = dict(model="funk_svd", trainer="dense", mesh=mesh, leaves=jax_out[0],
                  compile=dict(optimizer="adam", lr=1e-2, loss="bce"), batches=batches,
                  eval=W.funk_svd_batch(rng, 40), eval_batch=16, save_load=mesh == (2, 2))
    results, _ = mesh_against_one_process(inputs, tmp_path)
    against_jax(results, jax_out)


@pytest.mark.parametrize("mesh", MESHES)
def test_sparse_trainer_on_a_mesh_matches_jax_and_one_process(mesh, tmp_path):
    rng = np.random.default_rng(2)
    batches = [W.dcnv2_batch(rng, 32) for _ in range(3)]
    jax_out = jax_run("dcnv2", mesh, batches, lr=0.05)
    assert jax_out[3], "JAX's unpacked tables carry moments"
    inputs = dict(model="dcnv2", model_kwargs=dict(unified_embedding=True), trainer="sparse",
                  mesh=mesh, leaves=jax_out[0],
                  compile=dict(optimizer="adam", lr=0.05, loss="bce"), batches=batches,
                  eval=W.dcnv2_batch(rng, 40), eval_batch=16, save_load=mesh == (2, 2))
    results, _ = mesh_against_one_process(inputs, tmp_path)
    against_jax(results, jax_out)


SPARSE_FORMATS = {"packed_f32": (dict(unified_embedding=True), dict(packed_tables=True)),
                  "bytes": (dict(unified_embedding=True), dict(packed_bytes=True)),
                  "per_field": ({}, {})}


@pytest.mark.parametrize("fmt", sorted(SPARSE_FORMATS))
def test_sparse_formats_on_a_mesh_match_one_process(fmt, tmp_path):
    model_kwargs, trainer_kwargs = SPARSE_FORMATS[fmt]
    rng = np.random.default_rng(3)
    inputs = dict(model="dcnv2", model_kwargs=model_kwargs, trainer="sparse",
                  trainer_kwargs=trainer_kwargs, mesh=(2, 2),
                  compile=dict(optimizer="adam", lr=0.05, loss="bce"),
                  batches=[W.dcnv2_batch(rng, 32) for _ in range(3)],
                  eval=W.dcnv2_batch(rng, 40), eval_batch=16)
    mesh_against_one_process(inputs, tmp_path)


QUANTIZED = [("classic", mesh) for mesh in MESHES] + [("int8", (2, 2))]


@pytest.mark.parametrize("table,mesh", QUANTIZED)
def test_quantized_trainer_on_a_mesh_matches_one_process(table, mesh, tmp_path):
    """The q bytes equal the one process's: each shard keys B8's (and B3's)
    rounding bits by the global ids of its rows."""
    packed = table == "int8"
    rng = np.random.default_rng(4)
    inputs = dict(model="dcnv2", trainer="quantized", mesh=mesh,
                  model_kwargs=dict(unified_embedding=True, quantized_embedding=True,
                                    table_packed=packed),
                  trainer_kwargs=dict(packed_tables=packed),
                  compile=dict(optimizer="adam", lr=0.05, loss="bce"),
                  batches=[W.dcnv2_batch(rng, 16, unique=True) for _ in range(3)],
                  eval=W.dcnv2_batch(rng, 40), eval_batch=16, save_load=mesh == (2, 2))
    results, want = mesh_against_one_process(inputs, tmp_path)
    q = want["state"]["params"]["unified_q"]
    assert not torch.equal(q, torch.zeros_like(q))
