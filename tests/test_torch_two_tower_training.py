"""The slice end to end on the CPU: two-tower training under the in-batch
softmax, the port against JAX.

A small TwoTower (E=8, towers (16, 8), 60 users, 200 items, normalized,
temperature 0.05) is set up in JAX with ``compile("adam", lr=1e-2,
loss="softmax")`` (``tests/test_two_tower.py``'s lr) and
``init_state(seed=0)``, its weights and f32 tables then scaled from the
init's N(0, 0.01) by ``WEIGHT_SCALE`` to N(0, 0.3) (the int8 table through
its scales), under

* ``SparseEmbeddingTrainer(packed_tables=True)``: two packed ``[V, 64]`` f32
  leaves, ``u_embeddings/embedding`` and ``i_embeddings/embedding`` (lazy
  Adam), the towers under the dense Adam;
* ``QuantizedEmbeddingTrainer(packed_tables=True)``: the int8 ``i_q`` rows
  (rowwise Adagrad at the shared lr, as neither model sets a table lr;
  id-keyed stochastic requantization salted on the path ``i_q``), the f32
  user table in the dense Adam.

Their leaves load into the port's trainer with ``params_from_jax``; both take
5 steps on the same numpy batches of 16 rows, ``iid [16, 1]`` and
``[16, 4]`` (positive first; the other columns are gathered and take lazy
steps with zero gradients), item ids Zipf-skewed so positives repeat within
a batch, one case with ``mask_accidental_hits`` and a float64 ``Q_KEY``
column.

Why the scale: at N(0, 0.01) every tower output is about its bias, every
in-batch logit is about 1 / 0.05 and the softmax's gradients cancel to near
Adam's eps, where ``m / (sqrt(v) + eps)`` turns the two frameworks'
last-bit differences into percents of a step (``tests/test_two_tower.py``
calls it the plateau).

Tolerances (ROADMAP.md "Parity"): each step's loss rtol 1e-5; every packed
leaf and dense parameter after 5 steps rtol 1e-4 / atol 1e-6; int8 rows'
scale and accumulator so, their q values off by at most one in at most 0.1%
of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.loss import losses as jax_losses
from pytorchrec_tpu.models.two_tower import TwoTower as JaxTwoTower
from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.loss import get_loss, softmax_ce_loss
from pytorchrec_tpu_torch.models import TwoTower
from pytorchrec_tpu_torch.ops.kernels.quantize import requantize_rows
from pytorchrec_tpu_torch.ops.kernels.retrieval_topk import bin_max_scores
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

USERS, ITEMS, E, BATCH, STEPS, LR = 60, 200, 8, 16, 5, 1e-2
WEIGHT_SCALE = 30.0
SIZES = dict(emb_size=E, layers=(16, 8))
U, I, Q = "u_embeddings/embedding", "i_embeddings/embedding", "i_q"
KERNELS = (bin_max_scores, segmented_sum_scan, requantize_rows, scatter_set_rows)


def _columns(fc):
    col = fc.CategoricalColumnWithIdentity
    return dict(uid_column=col(feature_name="uid", category_num=USERS),
                iid_column=col(feature_name="iid", category_num=ITEMS))


def _batches(n_cand, logq=False, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"uid": rng.integers(0, USERS, size=BATCH).astype(np.int32),
                 "iid": np.minimum(rng.zipf(1.5, (BATCH, n_cand)), ITEMS - 1).astype(np.int32)}
        if logq:
            batch[TwoTower.Q_KEY] = rng.uniform(0.01, 0.5, size=BATCH)  # float64
        out.append(batch)
    return out


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _scaled(path, value):
    if path != Q:
        return value * np.float32(WEIGHT_SCALE)
    q, scale, acc = jqp.unpack_quantized_table(jnp.asarray(value), E, 8, 1)
    return np.asarray(jqp.pack_quantized_table(q, scale * WEIGHT_SCALE, acc, E, 8, 1))


def _pair(jax_cls, port_cls, batches, model_kwargs=(), **trainer_kwargs):
    """The JAX trainer and the port's, from the same scaled state."""
    model_kwargs = dict(model_kwargs)
    jax_trainer = jax_cls(JaxTwoTower(**_columns(jfc), **SIZES, **model_kwargs), **trainer_kwargs)
    jax_trainer.compile(optimizer="adam", lr=LR, loss="softmax", metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    flat = {k: _scaled(k, v) for k, v in _flat(jax_trainer.state.params).items()}
    params = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                           for k, v in flat.items()})
    jax_trainer.state = jax_trainer.state.replace(params=params)
    port = port_cls(_port_model(**model_kwargs), device="cpu", **trainer_kwargs)
    port.compile(optimizer="adam", lr=LR, loss="softmax")
    port.init_state(batches[0], seed=0)
    params_from_jax(flat, port)
    return jax_trainer, port


def _port_model(**kwargs):
    return TwoTower(**_columns(tfc), **SIZES, **kwargs, device="cpu",
                    generator=torch.Generator().manual_seed(0))


def _step_both(jax_trainer, port, batches):
    before = [k.launches for k in KERNELS]
    for step, batch in enumerate(batches):
        want = float(jax_trainer._train_step(batch))
        got = port.train_step(batch)
        assert got.shape == () and port.state.step == step + 1
        np.testing.assert_allclose(float(got), want, rtol=1e-5, err_msg=f"step {step}")
    assert [k.launches for k in KERNELS] == before  # the CPU runs the plain versions


def _assert_dense_match(port, flat, skip=(), **model_kwargs):
    want = params_from_jax(flat, _port_model(**model_kwargs)).state_dict()
    for key, value in port.model.state_dict().items():
        if key not in skip:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)


def _touched(batches, key, size):
    touched = np.zeros(size, bool)
    for batch in batches:
        touched[batch[key].reshape(-1)] = True
    return touched


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_softmax_ce_loss_matches_jax(reduction):
    logits = (np.random.default_rng(1).normal(size=(32, 10)) * 20).astype(np.float32)
    want = jax_losses.softmax_ce_loss(jnp.asarray(logits), None, reduction=reduction)
    got = get_loss("softmax")(torch.from_numpy(logits), None, reduction=reduction)
    assert get_loss("softmax") is softmax_ce_loss and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        softmax_ce_loss(torch.zeros(32, 1))
    with pytest.raises(ValueError):
        softmax_ce_loss(torch.zeros(32))


@pytest.mark.parametrize("n_cand,logq", [(1, False), (4, False), (4, True)])
def test_five_packed_train_steps_match_jax(n_cand, logq):
    batches = _batches(n_cand, logq)
    model_kwargs = {"mask_accidental_hits": True} if logq else {}
    jax_trainer, port = _pair(SparseEmbeddingTrainer, TorchSparseTrainer, batches,
                              model_kwargs=model_kwargs, packed_tables=True)
    assert sorted(port.state.packed) == [I, U]
    assert port.state.packed[I].shape == (ITEMS, 64) and port.state.packed[U].shape == (USERS, 64)
    addresses = {path: t.data_ptr() for path, t in port.state.packed.items()}
    start = {path: t.clone() for path, t in port.state.packed.items()}
    _step_both(jax_trainer, port, batches)
    assert {path: t.data_ptr() for path, t in port.state.packed.items()} == addresses

    flat = _flat(jax_trainer.state.params)
    for path in (U, I):
        np.testing.assert_allclose(port.state.packed[path].numpy(), flat[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)
    touched = torch.from_numpy(_touched(batches, "iid", ITEMS))
    items = port.state.packed[I]
    assert torch.equal(items[~touched], start[I][~touched])  # lazy: untouched rows stay
    assert port.model.i_embeddings.embedding.data_ptr() == items.data_ptr()
    _assert_dense_match(port, flat, **model_kwargs)


def test_five_int8_packed_train_steps_match_jax():
    batches = _batches(2)
    int8 = {"quantized_table": True}
    jax_trainer, port = _pair(QuantizedEmbeddingTrainer, TorchQuantizedTrainer, batches,
                              model_kwargs=int8, packed_tables=True)
    assert port._table_lr == LR  # no table lr on the model: the shared lr, as in JAX
    assert list(port.state.packed) == [Q]
    assert any(p is port.model.u_embeddings.embedding
               for group in port.state.optimizer.param_groups for p in group["params"])
    packed = port.state.packed[Q]
    start = packed.clone()
    _step_both(jax_trainer, port, batches)
    assert port.state.packed[Q].data_ptr() == packed.data_ptr() == port.model.i_q.data_ptr()

    flat = _flat(jax_trainer.state.params)
    touched = _touched(batches, "iid", ITEMS)
    assert torch.equal(packed[torch.from_numpy(~touched)], start[torch.from_numpy(~touched)])
    (gq, gs, ga), (wq, ws, wa) = (port.unpacked_quantized()["i"],
                                  jqp.unpack_quantized_table(flat[Q], E, 8, 1))
    gq, gs, ga = (np.asarray(a)[touched] for a in (gq, gs, ga))
    wq, ws, wa = (np.asarray(a)[touched] for a in (wq, ws, wa))
    diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000), diff.sum()
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ga, wa, rtol=1e-4, atol=1e-6)
    positives = np.zeros(ITEMS, bool)
    for batch in batches:
        positives[batch["iid"][:, 0]] = True
    # positives take gradients; the second column's rows are gathered with none
    assert (ga[positives[touched]] > 0).all() and (ga == 0).any()
    _assert_dense_match(port, flat, skip=(Q,), **int8)


def test_protocols_and_rows_injection():
    """Both protocols name the tables with their ids and keys; injected rows
    give the scores of the model's own gathers; global negatives raise."""
    batch = {k: torch.as_tensor(v) for k, v in _batches(3, n=1)[0].items()}
    model = _port_model()
    specs = model.sharded_table_specs(batch)
    assert [s["path"] for s in specs.values()] == [U, I]
    assert [s["rows_key"] for s in specs.values()] == [TwoTower.U_ROWS_KEY, TwoTower.I_ROWS_KEY]
    assert set(model.sparse_table_ids(batch)) == {U, I}
    with torch.no_grad():
        want, target = model(batch, train=True)
        assert want.shape == (BATCH, BATCH) and target[:, 0].eq(1).all()
        injected = {**batch,
                    TwoTower.U_ROWS_KEY: model.u_embeddings.embedding[batch["uid"].long()],
                    TwoTower.I_ROWS_KEY: model.i_embeddings.embedding[batch["iid"].reshape(-1)
                                                                      .long()]}
        torch.testing.assert_close(model(injected, train=True)[0], want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        model.quantized_table_spec(batch)
    quantized = _port_model(quantized_table=True)
    assert quantized.sharded_table_specs(batch)["i"]["path"] == Q
    assert [s["q"] for s in quantized.quantized_table_spec(batch).values()] == [Q]
    with pytest.raises(NotImplementedError):
        _port_model(global_negatives_axis="data")
