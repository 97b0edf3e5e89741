"""The port's ``ShardedSparseEmbeddingTrainer`` over gloo on the CPU against
JAX's on the first ``d * m`` devices of its 8-device CPU mesh, and against
the port's one-process trainer, from the same starting leaves (JAX's, in
its layout: ``hot_tables/<path>`` fragments under hot/cold) on the same
global batches, 3 steps.

Each test is one world running a group of scenarios (a model, the sharded
trainer's arguments): FunkSVD at (2, 2) and (1, 2) under Adam, Adagrad and
rowwise Adagrad for the 1-D and grid layouts, the two-hop exchange, bounded
capacities (1: every step overflows), hot/cold and packed f32 rows; DCN-v2
with the unified tables, the int8 row-grad exchange and int8 dense-gradient
compression; DLRM's int8 byte rows (1-D, the grid's two hops, hot/cold)
and bf16 rows. Tolerances, ROADMAP's parity rule:

* against JAX's sharded trainer: each step's loss rtol 1e-5; every leaf of
  the state (the fragments, the packed rows with their moments), the
  unpacked tables' moments and the compression's residuals rtol 1e-4 /
  atol 1e-6 (f32 after N steps); int8 rows' q bytes at most one apart (the
  duplicate-id rule: a sum in another order may cross a rounding
  threshold), their scale and accumulator f32 fields within the f32
  tolerance; bf16 rows within one bf16 step (rel 2**-7);
* against the one-process trainer (``SparseEmbeddingTrainer``, or the
  packed ``QuantizedEmbeddingTrainer`` for int8 rows, from the merged
  leaves): the merged tables and every dense leaf, the same tolerances,
  and the eval batch's scores rtol 1e-4 / atol 1e-6. The int8 wire formats
  (``qgrad_exchange``, ``grad_compression``) are lossy by design, so those
  runs are held to JAX's sharded trainer only. Under hot/cold the int8
  hot fragment keys its rounding bits by fragment ids (JAX's rule), so
  those rows are held to the one process within 4 quantization steps and
  their accumulators rtol 1e-5 (``tests/test_sharded_quantized.py``'s
  bounds), and the dense leaves and scores, which read them, to JAX's
  sharded trainer only.

A save and a restore on the mesh give the state back bit for bit (the
hot/cold moments and the compression residuals included).
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

import torch_mesh_workers as MW
import torch_sharded_workers as W
from pytorchrec_tpu.feature_column import CategoricalColumnWithIdentity as JaxCategorical
from pytorchrec_tpu.feature_column import NumericColumn as JaxNumeric
from pytorchrec_tpu.parallel import hot_cold as jax_hot_cold
from pytorchrec_tpu.parallel import make_mesh as jax_make_mesh
from pytorchrec_tpu.training import ShardedSparseEmbeddingTrainer as JaxSharded
from pytorchrec_tpu_torch.utils.convert import UNREAD_LEAVES

RTOL, ATOL = 1e-4, 1e-6
BF16_RTOL = 2.0 ** -7
LR = 0.01
STEPS, BATCH = 3, 32


def flat(tree) -> dict:
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def jax_model(name, **kwargs):
    from pytorchrec_tpu.models import DCNv2, DLRM, FunkSVD

    label = JaxCategorical(feature_name="label", category_num=2)
    if name == "funk_svd":
        return FunkSVD(uid_column=JaxCategorical(feature_name="uid", category_num=W.USERS),
                       iid_column=JaxCategorical(feature_name="iid", category_num=W.ITEMS),
                       label_column=label, emb_size=8, table_row_multiple=W.ROW_MULTIPLE,
                       **kwargs)
    dense = (JaxNumeric(feature_name="d_0"),)
    if name == "dcnv2":
        return DCNv2(sparse_columns=tuple(JaxCategorical(feature_name=k, category_num=v)
                                          for k, v in W.FIELDS.items()),
                     dense_columns=dense, label_column=label, emb_size=4, num_cross_layers=2,
                     layers=(8,), unified_embedding=True, table_row_multiple=W.ROW_MULTIPLE,
                     **kwargs)
    return DLRM(sparse_columns=tuple(JaxCategorical(feature_name=f"c_{i}",
                                                    category_num=W.DLRM_VOCAB)
                                     for i in range(W.DLRM_FIELDS)),
                dense_columns=dense, label_column=label, emb_size=8, bottom_layers=(16,),
                top_layers=(16,), unified_embedding=True, table_row_multiple=8, **kwargs)


def jax_run(scenario, mesh_shape) -> dict:
    """JAX's sharded trainer: the starting leaves (its layout), the
    one-process leaves they merge to, each step's loss, the final state."""
    d, m = mesh_shape
    mesh = jax_make_mesh(data=d, model=m, devices=jax.devices()[:d * m])
    trainer = JaxSharded(jax_model(scenario["model"], **scenario.get("model_kwargs", {})),
                         mesh=mesh, **scenario["trainer_kwargs"])
    trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=("auc",))
    trainer.init_state(scenario["batches"][0], seed=0)
    leaves = flat(trainer.state.params)
    merged = dict(leaves)
    for path, layout in trainer._hot_layouts.items():
        merged[path] = jax_hot_cold.merge_table(merged.pop("hot_tables/" + path), merged[path],
                                                layout)
    losses = [float(trainer._train_step(b)) for b in scenario["batches"]]
    return {"leaves": leaves, "merged_leaves": merged, "losses": losses,
            "params": flat(trainer.state.params), "moments": flat(trainer.state.table_moments),
            "residual": flat(getattr(trainer.state, "grad_residual", None) or {})}


def close(got, want, path, emb=None):
    """One leaf against its twin under the module docstring's rules."""
    got = torch.as_tensor(np.asarray(got)) if not isinstance(got, torch.Tensor) else got
    if not isinstance(want, torch.Tensor):
        want = np.asarray(want)
        want = (torch.from_numpy(want.view(np.uint16)).view(torch.bfloat16)
                if want.dtype.name == "bfloat16" else torch.from_numpy(np.array(want)))
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype, (
        path, tuple(got.shape), got.dtype, tuple(want.shape), want.dtype)
    if got.dtype == torch.uint8:  # int8 rows: q bytes, then scale || acc
        diff = (got[:, :emb].view(torch.int8).int() - want[:, :emb].view(torch.int8).int()).abs()
        assert int(diff.max()) <= 1, f"{path}: q bytes {int(diff.max())} apart"
        fields = slice(emb, emb + 8)
        torch.testing.assert_close(got[:, fields].contiguous().view(torch.float32),
                                   want[:, fields].contiguous().view(torch.float32),
                                   rtol=RTOL, atol=ATOL, msg=lambda m: f"{path}: {m}")
    elif got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=ATOL,
                                   msg=path)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"{path}: {m}")


def within_quanta(got, want, emb, path):
    """int8 rows whose hot fragment keys its rounding bits by fragment ids
    (JAX's hot/cold rule): the dequantized rows within 4 quantization
    steps, the accumulators (f32 optimizer state) rtol 1e-5, as JAX's
    ``tests/test_sharded_quantized.py`` holds them."""
    from pytorchrec_tpu_torch.ops.kernels.quantize import dequantize_rows
    from pytorchrec_tpu_torch.ops.quantized_packed import unpack_quantized_table

    q0, s0, a0 = unpack_quantized_table(want, emb, 8, 1)
    q1, s1, a1 = unpack_quantized_table(got, emb, 8, 1)
    quantum = float(s0.max())
    diff = (dequantize_rows(q1, s1) - dequantize_rows(q0, s0)).abs().max()
    assert float(diff) <= 4 * quantum, (path, float(diff), quantum)
    torch.testing.assert_close(a1, a0, rtol=1e-5, atol=1e-10, msg=path)


def check_group(group, tmp_path):
    mesh_shape, scenarios = GROUPS[group]
    rng = np.random.default_rng(sorted(GROUPS).index(group))
    jax_out = {}
    for name, sc in scenarios.items():
        sc["lr"] = LR
        sc["batches"] = [W.batch(sc["model"], rng, BATCH) for _ in range(STEPS)]
        sc["eval"] = W.batch(sc["model"], rng, BATCH)
        jax_out[name] = jax_run(sc, mesh_shape)
        sc["leaves"] = jax_out[name]["leaves"]
    torch.save({"mesh": mesh_shape, "scenarios": scenarios}, tmp_path / "inputs.pt")
    ranks = MW.run_world(W.scenarios_rank, mesh_shape[0] * mesh_shape[1], tmp_path)
    for name, sc in scenarios.items():
        want, emb = jax_out[name], 8
        for rank, result in enumerate(ranks):
            got = result[name]
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                                       err_msg=f"{name} rank {rank}")
            # leaves JAX's DCN-v2 makes and never reads, which the port lacks
            assert set(got["state"]["params"]) == set(want["params"]) - (
                UNREAD_LEAVES - set(got["state"]["params"])), name
            for path, value in got["state"]["params"].items():
                close(value, want["params"][path], f"{name}: {path}", emb)
            for path, value in want["moments"].items():
                table, key = path.rsplit("/", 1)
                close(got["state"]["table_moments"][table][key], value, f"{name}: {path}")
            assert set(got["state"]["grad_residual"]) == set(want["residual"]), name
            for path, value in want["residual"].items():
                close(got["state"]["grad_residual"][path], value, f"{name}: residual {path}")
            if sc.get("save_load"):
                assert got["restored"], name
        np.testing.assert_allclose(ranks[0][name]["predictions"], ranks[-1][name]["predictions"])
        if sc.get("lossy"):
            continue
        one = W.one_process(sc, want["merged_leaves"])
        np.testing.assert_allclose(ranks[0][name]["losses"], one["losses"], rtol=1e-5)
        merged = ranks[0][name]["merged"]
        for path, value in one["state"]["params"].items():
            if path in sc.get("one_process_unpack", ()):
                value = value[:, :merged[path].shape[1]].float()
            if sc.get("quanta"):  # the tables only: the rest reads rows quanta apart
                if value.dtype == torch.uint8:
                    within_quanta(merged[path], value, emb, f"{name}: one process {path}")
                continue
            close(merged[path], value, f"{name}: one process {path}", emb)
        if sc.get("quanta"):
            continue
        np.testing.assert_allclose(ranks[0][name]["predictions"], one["predictions"],
                                   rtol=RTOL, atol=ATOL, err_msg=name)


COUNTS = {"u": np.random.default_rng(3).integers(0, 100, size=W.USERS),
          "i": np.random.default_rng(4).integers(0, 100, size=W.ITEMS)}
PACKED_FUNK = ("u_embeddings/embedding", "i_embeddings/embedding")
INT8 = dict(quantized_embedding=True, table_packed=True)
DLRM_COUNTS = {"unified": np.random.default_rng(7).zipf(1.5, size=W.DLRM_VOCAB * W.DLRM_FIELDS)
               .astype(np.float64)}

# group -> (mesh, {scenario: {"model", "trainer_kwargs", ...}})
GROUPS = {
    "funk_unpacked": ((2, 2), {
        "adam-1d": dict(model="funk_svd", trainer_kwargs={}),
        "adagrad-grid": dict(model="funk_svd",
                             trainer_kwargs=dict(table_optimizer="adagrad", strategy="grid")),
        "rowwise-1d-cap1": dict(model="funk_svd",
                                trainer_kwargs=dict(table_optimizer="rowwise_adagrad",
                                                    exchange_capacity=1, table_lr=0.05)),
    }),
    "funk_packed": ((2, 2), {
        "adam-1d-cap1": dict(model="funk_svd", one_process_unpack=PACKED_FUNK,
                             trainer_kwargs=dict(packed_tables=True, exchange_capacity=1)),
        "rowwise-grid": dict(model="funk_svd", one_process_unpack=PACKED_FUNK,
                             trainer_kwargs=dict(packed_tables=True, strategy="grid",
                                                 table_optimizer="rowwise_adagrad",
                                                 table_lr=0.05)),
        "adam-two_hop-2.0": dict(model="funk_svd", one_process_unpack=PACKED_FUNK,
                                 trainer_kwargs=dict(packed_tables=True, strategy="grid",
                                                     two_hop=True, exchange_capacity=2.0)),
    }),
    "funk_hot_cold": ((2, 2), {
        "adam": dict(model="funk_svd", save_load=True,
                     trainer_kwargs=dict(strategy="hot_cold", hot_counts=COUNTS, hot_rows=16)),
        "adam-packed": dict(model="funk_svd", one_process_unpack=PACKED_FUNK,
                            trainer_kwargs=dict(strategy="hot_cold", hot_counts=COUNTS,
                                                hot_rows=16, packed_tables=True)),
        "adagrad-mass": dict(model="funk_svd",
                             trainer_kwargs=dict(strategy="hot_cold", hot_counts=COUNTS,
                                                 hot_rows=0.5, table_optimizer="adagrad")),
    }),
    "funk_model_axis_only": ((1, 2), {
        "adam-packed": dict(model="funk_svd", one_process_unpack=PACKED_FUNK,
                            trainer_kwargs=dict(packed_tables=True)),
        "rowwise-hot_cold": dict(model="funk_svd",
                                 trainer_kwargs=dict(strategy="hot_cold", hot_counts=COUNTS,
                                                     hot_rows=16, table_lr=0.05,
                                                     table_optimizer="rowwise_adagrad")),
        "adam-two_hop-4": dict(model="funk_svd",
                               trainer_kwargs=dict(strategy="grid", two_hop=True,
                                                   exchange_capacity=4)),
    }),
    "dcnv2": ((2, 2), {
        "unified-1d": dict(model="dcnv2", trainer_kwargs={}),
        "qgrad_exchange": dict(model="dcnv2", lossy=True,
                               trainer_kwargs=dict(packed_tables=True, qgrad_exchange=True)),
        "grad_compression": dict(model="dcnv2", lossy=True, save_load=True,
                                 trainer_kwargs=dict(grad_compression="int8",
                                                     grad_compression_min_size=16)),
    }),
    "dlrm_rows": ((2, 2), {
        "int8-1d": dict(model="dlrm", model_kwargs=INT8,
                        trainer_kwargs=dict(packed_tables=True)),
        "int8-two_hop": dict(model="dlrm", model_kwargs=INT8,
                             trainer_kwargs=dict(packed_tables=True, strategy="grid",
                                                 two_hop=True, exchange_capacity=2.0)),
        "int8-hot_cold": dict(model="dlrm", model_kwargs=INT8, quanta=True,
                              trainer_kwargs=dict(packed_tables=True, strategy="hot_cold",
                                                  hot_counts=DLRM_COUNTS, hot_rows=0.5)),
        "bf16-1d": dict(model="dlrm", one_process_unpack=("unified_emb/embedding",),
                        trainer_kwargs=dict(packed_tables=True, packed_dtype="bfloat16")),
    }),
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_sharded_trainer_matches_jax_and_one_process(group, tmp_path):
    check_group(group, tmp_path)


# (mesh, trainer arguments) JAX's constructor refuses with an assert
GUARDS = {
    "no_mesh": (None, {}),
    "strategy": ((1, 2), dict(strategy="2d")),
    "qgrad_two_hop": ((1, 2), dict(strategy="grid", two_hop=True, qgrad_exchange=True)),
    "qgrad_hot_cold": ((1, 2), dict(strategy="hot_cold", hot_counts=COUNTS,
                                    qgrad_exchange=True)),
    "compression": ((1, 2), dict(grad_compression="fp16")),
    "model_axis_1": ((2, 1), {}),
    "hot_cold_model_axis_1": ((2, 1), dict(strategy="hot_cold", hot_counts=COUNTS)),
    "grid_of_one": ((1, 1), dict(strategy="grid")),
    "two_hop_1d": ((1, 2), dict(two_hop=True)),
    "hot_cold_no_counts": ((1, 2), dict(strategy="hot_cold")),
}


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_constructor_guards_refuse_as_jax_does(guard):
    """Each argument set JAX's constructor refuses (an ``AssertionError``)
    the port refuses too (``ValueError``); a world of one is never
    accepted."""
    from pytorchrec_tpu_torch.parallel import Mesh
    from pytorchrec_tpu_torch.training import ShardedSparseEmbeddingTrainer

    shape, kwargs = GUARDS[guard]
    jax_mesh = port_mesh = None
    if shape is not None:
        d, m = shape
        jax_mesh = jax_make_mesh(data=d, model=m, devices=jax.devices()[:d * m])
        port_mesh = Mesh(data=d, model=m, rank=0, device=torch.device("cpu"))
    with pytest.raises(AssertionError):
        JaxSharded(jax_model("funk_svd"), mesh=jax_mesh, **kwargs)
    with pytest.raises(ValueError):
        ShardedSparseEmbeddingTrainer(W.funk_svd("cpu"), mesh=port_mesh, **kwargs)


def test_constructor_refuses_a_model_without_sharded_tables():
    from pytorchrec_tpu_torch.parallel import Mesh
    from pytorchrec_tpu_torch.training import ShardedSparseEmbeddingTrainer

    class NoSpecs(torch.nn.Module):
        sparse_table_ids = None

    with pytest.raises(TypeError):
        ShardedSparseEmbeddingTrainer(NoSpecs(), mesh=Mesh(data=1, model=2, rank=0,
                                                           device=torch.device("cpu")))
