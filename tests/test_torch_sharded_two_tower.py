"""The port's two-tower model on the mesh, over gloo on the CPU, against
JAX's on the first ``d * m`` devices of its 8-device CPU mesh and against the
port's one-process trainer.

* **Cross-replica negatives** (``TwoTower(global_negatives_axis="data")``)
  at (2, 2): 3 steps of ``ShardedSparseEmbeddingTrainer`` (1-D, unpacked as
  JAX's default and packed f32) from JAX's starting leaves on the same
  global batches, with logQ and accidental-hit masking on (duplicate
  positives planted on one rank and across ranks), against JAX's sharded
  trainer (the counterpart of ``tests/test_two_tower.py:337-367``) and
  against the port's one-process trainer with local negatives over the
  whole batch: the pool of ``d`` ranks' ``B/d`` positives is the
  one-process in-batch pool, and a masked column's ``exp(-1e9)`` is 0.
* **Local negatives on the mesh** at (2, 2), against JAX's local-negative
  sharded run (each rank's pool its own ``B/d`` rows: no one-process twin).
* **int8 item table**, 1-D at (2, 2), one step on point-wise rows, against
  the one-process ``QuantizedEmbeddingTrainer`` with JAX's bounds
  (``tests/test_two_tower.py:394-440``: losses 1e-5 apart, q bytes equal,
  scales within 2e-7).
* **The forward at (4, 1)** (``test_data4_scores_global_pool``'s port): the
  model inside ``parallel.mesh.bound`` gives JAX's ``shard_map`` prediction
  ``[B, dB + 1]``, and the gather's backward (``reduce_scatter_tensor``)
  gives ``jax.grad``'s gradients of the same scalar through it.
* Outside a bound mesh the training forward raises, as JAX's unbound axis.

Every run starts from JAX's init scaled by ``WEIGHT_SCALE`` (out of the
softmax's plateau, as ``tests/test_torch_two_tower_training.py`` does).
Tolerances, ROADMAP's parity rule: losses rtol 1e-5; every leaf of the
state rtol 1e-4 / atol 1e-6 (f32 after N steps), and the eval batch's
cosines (the scores times the temperature) so against the one-process run;
a forward rtol 1e-5.
"""

import functools

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
from pytorchrec_tpu.training import ShardedSparseEmbeddingTrainer as JaxSharded

RTOL, ATOL = 1e-4, 1e-6
LR = 0.01
STEPS, BATCH = 3, 32
GLOBAL = dict(global_negatives_axis="data", mask_accidental_hits=True)
LOCAL = dict(mask_accidental_hits=True)
PACKED_TT = ("u_embeddings/embedding", "i_embeddings/embedding")
# the starting weights and tables scaled from the init's N(0, 0.01) to N(0, 0.3):
# at the init the in-batch softmax's gradients cancel to near Adam's eps, where
# two frameworks' last-bit differences become percents of a step
# (tests/test_torch_two_tower_training.py's WEIGHT_SCALE and its reason)
WEIGHT_SCALE = 30.0
TEMPERATURE = 0.05  # the model's default: scores are cosines / 0.05


def flat(tree) -> dict:
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def jax_two_tower(**kwargs):
    from pytorchrec_tpu.models import TwoTower

    return TwoTower(uid_column=JaxCategorical(feature_name="uid", category_num=W.TT_USERS),
                    iid_column=JaxCategorical(feature_name="iid", category_num=W.TT_ITEMS),
                    label_column=JaxCategorical(feature_name="label", category_num=2),
                    emb_size=8, layers=(16, 8), table_row_multiple=2, **kwargs)


def scaled(path: str, value: np.ndarray) -> np.ndarray:
    """A starting leaf scaled by ``WEIGHT_SCALE`` (the int8 table through its
    scales; packed rows' moments are zero at the start)."""
    from pytorchrec_tpu.ops import quantized_packed as jqp

    if path != "i_q":
        return value * np.float32(WEIGHT_SCALE)
    q, scale, acc = jqp.unpack_quantized_table(jnp.asarray(value), 8, 8, 1)
    return np.asarray(jqp.pack_quantized_table(q, scale * WEIGHT_SCALE, acc, 8, 8, 1))


def jax_run(scenario, mesh_shape) -> dict:
    """JAX's sharded trainer from its init scaled by ``WEIGHT_SCALE``: its
    starting leaves, each step's loss and the final state."""
    d, m = mesh_shape
    mesh = jax_make_mesh(data=d, model=m, devices=jax.devices()[:d * m])
    trainer = JaxSharded(jax_two_tower(**scenario["model_kwargs"]), mesh=mesh,
                         **scenario["trainer_kwargs"])
    trainer.compile(optimizer="adam", lr=LR, loss=scenario["loss"], metrics=())
    trainer.init_state(scenario["batches"][0], seed=0)
    leaves = {k: scaled(k, v) for k, v in flat(trainer.state.params).items()}
    placed = jax.tree_util.tree_map_with_path(
        lambda path, old: jax.device_put(
            leaves["/".join(str(getattr(p, "key", p)) for p in path)], old.sharding),
        trainer.state.params)
    trainer.state = trainer.state.replace(params=placed)
    losses = [float(trainer._train_step(b)) for b in scenario["batches"]]
    return {"leaves": leaves, "losses": losses, "params": flat(trainer.state.params),
            "moments": flat(trainer.state.table_moments)}


def close(got, want, path):
    """One leaf against its twin: int8 byte rows' q bytes at most one apart
    and their scale and accumulator fields, f32 rtol 1e-4 / atol 1e-6."""
    got = torch.as_tensor(np.asarray(got))
    want = torch.as_tensor(np.array(want))
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype, (
        path, tuple(got.shape), got.dtype, tuple(want.shape), want.dtype)
    if got.dtype == torch.uint8:
        diff = (got[:, :8].view(torch.int8).int() - want[:, :8].view(torch.int8).int()).abs()
        assert int(diff.max()) <= 1, f"{path}: q bytes {int(diff.max())} apart"
        got, want = (t[:, 8:16].contiguous().view(torch.float32) for t in (got, want))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"{path}: {m}")


def int8_against_one_process(got: dict, one: dict, name: str) -> None:
    """JAX's bounds for the int8 item table after one step
    (``tests/test_two_tower.py:437-440``): the losses 1e-5 apart, the q bytes
    equal and the scales within 2e-7; the other leaves at the f32 rule."""
    from pytorchrec_tpu_torch.ops.quantized_packed import unpack_quantized_table

    assert abs(got["losses"][0] - one["losses"][0]) < 1e-5, (got["losses"], one["losses"])
    q1, s1, _ = unpack_quantized_table(got["merged"]["i_q"], 8, 8, 1)
    q0, s0, _ = unpack_quantized_table(one["state"]["params"]["i_q"], 8, 8, 1)
    torch.testing.assert_close(q1, q0, rtol=0, atol=0)
    torch.testing.assert_close(s1, s0, rtol=0, atol=2e-7)
    for path, value in one["state"]["params"].items():
        if path != "i_q":
            close(got["merged"][path], value, f"{name}: one process {path}")


def check_group(group, tmp_path):
    mesh_shape, scenarios = GROUPS[group]
    rng = np.random.default_rng(sorted(GROUPS).index(group) + 40)
    jax_out = {}
    for name, sc in scenarios.items():
        pointwise = sc["loss"] == "bce"
        sc["lr"] = LR
        sc["batches"] = [W.two_tower_batch(rng, BATCH, pointwise)
                         for _ in range(sc.get("steps", STEPS))]
        sc["eval"] = W.two_tower_batch(rng, BATCH, pointwise)
        sc["eval"].pop(W.TT_Q_KEY, None)
        jax_out[name] = jax_run(sc, mesh_shape)
        sc["leaves"] = jax_out[name]["leaves"]
    torch.save({"mesh": mesh_shape, "scenarios": scenarios}, tmp_path / "inputs.pt")
    ranks = MW.run_world(W.scenarios_rank, mesh_shape[0] * mesh_shape[1], tmp_path)
    for name, sc in scenarios.items():
        want = jax_out[name]
        for rank, result in enumerate(ranks):
            got = result[name]
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                                       err_msg=f"{name} rank {rank}")
            assert set(got["state"]["params"]) == set(want["params"]), name
            for path, value in got["state"]["params"].items():
                close(value, want["params"][path], f"{name} rank {rank}: {path}")
            for path, value in want["moments"].items():
                table, key = path.rsplit("/", 1)
                close(got["state"]["table_moments"][table][key], value, f"{name}: {path}")
        for result in ranks[1:]:  # every rank scores the whole eval batch alike
            np.testing.assert_array_equal(result[name]["predictions"], ranks[0][name]["predictions"])
        if not sc.get("one_process"):
            continue
        one = W.one_process(sc, sc["leaves"])
        if sc["model_kwargs"].get("quantized_table"):
            int8_against_one_process(ranks[0][name], one, name)
            continue
        np.testing.assert_allclose(ranks[0][name]["losses"], one["losses"], rtol=1e-5,
                                   err_msg=name)
        merged = ranks[0][name]["merged"]
        for path, value in one["state"]["params"].items():
            if path in sc.get("one_process_unpack", ()):
                value = value[:, :merged[path].shape[1]].float()
            close(merged[path], value, f"{name}: one process {path}")
        # the eval scores are cosines over the temperature: held as cosines
        np.testing.assert_allclose(ranks[0][name]["predictions"] * TEMPERATURE,
                                   one["predictions"] * TEMPERATURE, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


# group -> (mesh, {scenario: ...}); "one_process": held against the
# one-process twin too, from the same (whole) leaves
GROUPS = {
    "global_negatives": ((2, 2), {
        "unpacked": dict(model="two_tower", loss="softmax", model_kwargs=GLOBAL,
                         one_process_model_kwargs=LOCAL, one_process=True,
                         trainer_kwargs={}),
        "packed_f32": dict(model="two_tower", loss="softmax", model_kwargs=GLOBAL,
                           one_process_model_kwargs=LOCAL, one_process=True,
                           one_process_unpack=PACKED_TT,
                           trainer_kwargs=dict(packed_tables=True)),
    }),
    "local_negatives_and_int8": ((2, 2), {
        "local": dict(model="two_tower", loss="softmax", model_kwargs=LOCAL, trainer_kwargs={}),
        "int8_pointwise": dict(model="two_tower", loss="bce", steps=1,
                               model_kwargs=dict(quantized_table=True), one_process=True,
                               trainer_kwargs=dict(packed_tables=True)),
    }),
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_sharded_two_tower_matches_jax_and_one_process(group, tmp_path):
    check_group(group, tmp_path)


# ---------------------------------------------------------------------------
# the forward and the gather's backward at (4, 1)
# ---------------------------------------------------------------------------

DATA4 = 4
U_ROWS, I_ROWS = "__rows__tt_u", "__rows__tt_i"


def jax_data4(batch: dict, w: np.ndarray) -> dict:
    """JAX's model under ``shard_map`` over ``data=4``: the prediction, and
    ``jax.grad`` of ``sum(prediction * w)`` with respect to the injected
    rows (data-sharded) and the parameters (replicated)."""
    from jax.sharding import PartitionSpec as P

    model = jax_two_tower(**GLOBAL, normalize=False)
    params = model.init(jax.random.PRNGKey(0), batch, False)
    mesh = jax_make_mesh(data=DATA4, model=1, devices=jax.devices()[:DATA4])
    leaves = flat(params["params"])
    rows = {U_ROWS: leaves["u_embeddings/embedding"][batch["uid"]],
            I_ROWS: leaves["i_embeddings/embedding"][batch["iid"]].reshape(-1, 8)}

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("data"), P("data")),
                       out_specs=P("data"), check_vma=False)
    def forward(p, b, r):
        return model.apply(p, {**b, **r}, True)[0]

    def total(p, r):
        return jnp.sum(forward(p, batch, r) * w)

    grads_p, grads_r = jax.grad(total, argnums=(0, 1))(params, rows)
    return {"leaves": leaves, "rows": rows, "prediction": np.asarray(forward(params, batch, rows)),
            "grad_rows": {k: np.asarray(v) for k, v in grads_r.items()},
            "grad_params": flat(grads_p["params"])}


def test_data4_forward_and_gather_backward_match_jax(tmp_path):
    """At data=4 each rank scores its 4 users against all 16 positives: the
    ``[B, 17]`` prediction as JAX's (within rtol 1e-5), its own column
    masked; the rows' gradients (each rank's own rows, the other ranks'
    cotangents summed in by the reduce-scatter) and the parameters'
    gradients (summed over the ranks) as ``jax.grad``'s."""
    rng = np.random.default_rng(9)
    batch = W.two_tower_batch(rng, 16)
    w = rng.normal(size=(16, 17)).astype(np.float32)
    want = jax_data4(batch, w)
    torch.save({"batch": batch, "w": w, "leaves": want["leaves"], "rows": want["rows"]},
               tmp_path / "inputs.pt")
    ranks = MW.run_world(W.tt_data4_rank, DATA4, tmp_path)
    prediction = np.concatenate([r["prediction"] for r in ranks])
    np.testing.assert_allclose(prediction, want["prediction"], rtol=1e-5, atol=1e-6)
    assert prediction.shape == (16, 17) and ((prediction[:, 1:] < -1e8).sum(axis=1) >= 1).all()
    for key in (U_ROWS, I_ROWS):
        got = np.concatenate([r["grad_rows"][key] for r in ranks])
        np.testing.assert_allclose(got, want["grad_rows"][key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    for path, value in want["grad_params"].items():
        if path in PACKED_TT:  # the rows are injected: the tables take no gradient
            continue
        np.testing.assert_allclose(ranks[0]["grad_params"][path], value, rtol=1e-4, atol=1e-6,
                                   err_msg=path)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["grad_params"][path], ranks[0]["grad_params"][path])


def test_global_negatives_need_a_bound_mesh():
    """Outside ``bound`` the training forward raises ``NameError`` (JAX's
    unbound axis name); the scoring forward names no axis and runs; a bound
    mesh without the axis raises ``ValueError``; leaving ``bound`` unbinds."""
    from pytorchrec_tpu_torch.parallel import Mesh, bound, bound_mesh

    model = W.two_tower("cpu", **GLOBAL)
    batch = {k: torch.as_tensor(v) for k, v in W.two_tower_batch(np.random.default_rng(1),
                                                                 8).items()}
    with torch.no_grad():
        with pytest.raises(NameError):
            model(batch, train=True)
        assert model(batch, train=False)[0].shape == (8, W.TT_CANDIDATES)
    mesh = Mesh(data=1, model=1, rank=0, device=torch.device("cpu"))
    with bound(mesh):
        assert bound_mesh("data") is mesh
        with pytest.raises(ValueError):
            bound_mesh("corpus")
    with pytest.raises(NameError):
        bound_mesh("data")
