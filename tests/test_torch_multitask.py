"""The multi-task family (SharedBottom, MMoE, PLE, ESMM) and the last two
losses (top1, esmm), the port against JAX on the CPU.

* Forwards: each model on 3 sparse fields of vocab 20 (E=4, per-field and
  unified tables) and 2 dense fields, point-wise rows with click and
  conversion labels, JAX's initial leaves loaded with ``params_from_jax``:
  predictions and targets rtol 1e-5 / atol 1e-6 (f32 forward,
  ``ROADMAP.md``). ``ExpertBank(per_expert=True)`` on ``[B, K, D]`` the
  same.
* Training: 5 steps of 32 rows (Zipf-skewed ids, seed 2) under ``Trainer``
  (per-field tables), ``SparseEmbeddingTrainer(packed_tables=True)``
  (packed f32), and ``QuantizedEmbeddingTrainer`` with int8 packed and
  classic tables, from JAX's leaves with the dense kernels spread (N(0, 2 /
  fan_in), ``tests/test_torch_reader_fit.py::_spread``: gradients away from
  Adam's eps window); ESMM under the ``esmm`` loss, the others under
  ``bce``. Losses rtol 1e-5; dense parameters rtol 1e-4 / atol 1e-6 (f32
  after N steps); f32 tables the same; int8 rows' scale and accumulator
  rtol 1e-4 / atol 1e-6 and their q values off by at most one in at most
  0.1% of them (``tests/test_torch_dlrm_training.py``'s rule).
* ``Trainer.compile`` rejects ``logloss/1`` on ESMM's log-probability
  column, as the JAX trainer does; ``auc/1`` is taken.
* Losses: top1 and esmm values (mean, sum, none) and gradients rtol 1e-5 /
  atol 1e-6, esmm with ``log p`` at and next to 0 included (finite).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.loss import losses as jax_losses
from pytorchrec_tpu.models import multitask as jmt
from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu.training import Trainer as JaxTrainer
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer as JaxQuantized
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer as JaxSparse
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.loss import get_loss
from pytorchrec_tpu_torch.models import multitask as tmt
from pytorchrec_tpu_torch.training import (
    QuantizedEmbeddingTrainer,
    SparseEmbeddingTrainer,
    Trainer,
)
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import leaves_of
from test_torch_reader_fit import _spread

VOCAB, N_SPARSE, N_DENSE, E, BATCH, STEPS, LR = 20, 3, 2, 4, 32, 5, 1e-2
MODELS = {
    "SharedBottom": dict(bottom_layers=(8, 4), tower_layers=(4,)),
    "MMoE": dict(n_experts=3, expert_layers=(8, 4)),
    "PLE": dict(n_levels=2, experts_per_group=2, expert_layers=(8, 4)),
    "ESMM": dict(bottom_layers=(8, 4)),
}
# table format -> (model kwargs, JAX trainer, port trainer)
FORMATS = {
    "dense": ({}, JaxTrainer, lambda m: Trainer(m, device="cpu")),
    "packed_f32": ({"unified_embedding": True}, lambda m: JaxSparse(m, packed_tables=True),
                   lambda m: SparseEmbeddingTrainer(m, device="cpu", packed_tables=True)),
    "int8_packed": ({"unified_embedding": True, "quantized_embedding": True,
                     "table_packed": True},
                    lambda m: JaxQuantized(m, packed_tables=True),
                    lambda m: QuantizedEmbeddingTrainer(m, device="cpu", packed_tables=True)),
    "classic_int8": ({"unified_embedding": True, "quantized_embedding": True}, JaxQuantized,
                     lambda m: QuantizedEmbeddingTrainer(m, device="cpu")),
}


def _columns(fc):
    label = fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2)
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=label,
        task_columns=(label, fc.CategoricalColumnWithIdentity(feature_name="conversion",
                                                              category_num=2)))


def _batches(n=STEPS, seed=2, rows=BATCH):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {f"c_{i}": np.minimum(rng.zipf(1.5, rows) - 1, VOCAB - 1).astype(np.int32)
                 for i in range(N_SPARSE)}
        batch.update({f"d_{i}": rng.normal(size=rows).astype(np.float32)
                      for i in range(N_DENSE)})
        batch["label"] = rng.integers(0, 2, rows).astype(np.int32)
        batch["conversion"] = (batch["label"] * rng.integers(0, 2, rows)).astype(np.int32)
        out.append(batch)
    return out


def _flat(tree):
    tree = jax.device_get(tree)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _models(name, **kwargs):
    return (getattr(jmt, name)(**_columns(jfc), emb_size=E, **MODELS[name], **kwargs),
            getattr(tmt, name)(**_columns(tfc), emb_size=E, **MODELS[name], **kwargs,
                               device="cpu"))


@pytest.mark.parametrize("unified", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(name, unified):
    batch = _batches(1, seed=3)[0]
    jax_model, port = _models(name, unified_embedding=unified)
    params = jax_model.init(jax.random.PRNGKey(0), batch)["params"]
    params_from_jax(_flat(params), port)
    want_pred, want_target = jax_model.apply({"params": params}, batch)
    with torch.no_grad():
        got_pred, got_target = port({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got_pred.shape == (BATCH, 2)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_target.numpy(), np.asarray(want_target))
    assert sorted(leaves_of(port)) == sorted(_flat(params))
    # serving: no labels, no targets
    served = {k: torch.from_numpy(v) for k, v in batch.items() if k not in ("label", "conversion")}
    with torch.no_grad():
        prediction, target = port(served)
    assert target is None
    np.testing.assert_allclose(prediction.numpy(), got_pred.numpy(), rtol=0, atol=0)


def test_expert_bank_per_expert_matches_jax():
    k, d = 5, 6
    x = np.random.default_rng(4).normal(size=(7, k, d)).astype(np.float32)
    bank = jmt.ExpertBank(k, (8, 3))
    params = bank.init(jax.random.PRNGKey(1), jnp.asarray(x), per_expert=True)["params"]
    port = tmt.ExpertBank(k, d, (8, 3), device="cpu")
    with torch.no_grad():
        for key, value in _flat(params).items():
            getattr(port, key).copy_(torch.from_numpy(value.copy()))
        got = port(torch.from_numpy(x), per_expert=True)
        shared = port(torch.from_numpy(x[:, 0]))
    assert got.shape == (7, k, 3) and shared.shape == (7, k, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(bank.apply({"params": params},
                                                                  jnp.asarray(x),
                                                                  per_expert=True)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(shared.numpy(), np.asarray(bank.apply({"params": params},
                                                                     jnp.asarray(x[:, 0]))),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        port(torch.zeros(2, k + 1, d), per_expert=True)


def _int8_triples(table, jax_trainer, port):
    flat = _flat(jax_trainer.state.params)
    if table == "int8_packed":
        got = port.unpacked_quantized()["unified"]
        want = jqp.unpack_quantized_table(flat["unified_q"], E, 8, 1)
    else:
        got = (port.model.unified_q, port.model.unified_scale, port.state.table_acc["unified"])
        want = (flat["unified_q"], flat["unified_scale"], jax_trainer.state.table_acc["unified"])
    return [np.asarray(a) for a in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("table", list(FORMATS))
@pytest.mark.parametrize("name", list(MODELS))
def test_training_matches_jax(name, table):
    batches = _batches()
    kwargs, jax_cls, port_cls = FORMATS[table]
    jax_model, port_model = _models(name, **kwargs)
    loss = "esmm" if name == "ESMM" else "bce"
    jax_trainer = jax_cls(jax_model)
    jax_trainer.compile(optimizer="adam", lr=LR, loss=loss, metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    flat = _spread(_flat(jax_trainer.state.params), E)
    jax_trainer.state = jax_trainer.state.replace(params=traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}))
    port = port_cls(port_model)
    port.compile(optimizer="adam", lr=LR, loss=loss, metrics=())
    port.init_state(batches[0], seed=0)
    params_from_jax(flat, port)
    for step, batch in enumerate(batches):
        np.testing.assert_allclose(float(port.train_step(batch)),
                                   float(jax_trainer._train_step(batch)), rtol=1e-5,
                                   err_msg=f"step {step}")
    want = _flat(jax_trainer.state.params)
    quantized = {"unified_q", "unified_scale"}
    for key, value in leaves_of(port).items():
        if key not in quantized:
            np.testing.assert_allclose(value.numpy(), want[key], rtol=1e-4, atol=1e-6,
                                       err_msg=key)
    if table in ("int8_packed", "classic_int8"):
        (gq, gs, ga), (wq, ws, wa) = _int8_triples(table, jax_trainer, port)
        diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
        assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000)
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ga, wa, rtol=1e-4, atol=1e-6)


def test_esmm_rejects_sigmoid_slices_on_its_log_probability():
    _, model = _models("ESMM")
    trainer = Trainer(model, device="cpu")
    with pytest.raises(ValueError, match="log-probabilities"):
        trainer.compile(loss="esmm", metrics=("auc/0", "logloss/1"))
    with pytest.raises(ValueError, match="log-probabilities"):
        trainer.compile(loss="esmm", metrics=("mse/1",))
    trainer.compile(loss="esmm", metrics=("auc/0", "auc/1", "logloss/0"))
    jax_trainer = JaxTrainer(_models("ESMM")[0])
    with pytest.raises(AssertionError):
        jax_trainer.compile(loss="esmm", metrics=("auc/0", "logloss/1"))
    mmoe = Trainer(_models("MMoE")[1], device="cpu")
    mmoe.compile(metrics=("logloss/1",))  # a logit column: taken


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_top1_loss_matches_jax(reduction):
    prediction = (np.random.default_rng(9).normal(size=(64, 2)) * 3).astype(np.float32)
    want = jax_losses.top1_loss(jnp.asarray(prediction), None, reduction=reduction)
    x = torch.from_numpy(prediction).requires_grad_()
    got = get_loss("top1")(x, None, reduction=reduction)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got.sum().backward()
    grad = jax.grad(lambda p: jnp.sum(jax_losses.top1_loss(p, None, reduction=reduction)))(
        jnp.asarray(prediction))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        get_loss("top1")(torch.zeros(4), None)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_esmm_loss_matches_jax(reduction):
    rng = np.random.default_rng(10)
    ctr = rng.normal(size=64) * 3
    log_p = -np.abs(rng.normal(size=64)) * 4
    log_p[:6] = [0.0, -1e-12, -1e-8, -1e-7, -2e-7, -1e-30]  # at and next to log p = 0
    prediction = np.stack([ctr, log_p], axis=-1).astype(np.float32)
    click = rng.integers(0, 2, 64)
    target = np.stack([click, click * rng.integers(0, 2, 64)], axis=-1).astype(np.float32)
    want = jax_losses.esmm_loss(jnp.asarray(prediction), jnp.asarray(target), reduction=reduction)
    x = torch.from_numpy(prediction).requires_grad_()
    got = get_loss("esmm")(x, torch.from_numpy(target), reduction=reduction)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got.sum().backward()
    grad = jax.grad(lambda p: jnp.sum(jax_losses.esmm_loss(p, jnp.asarray(target),
                                                           reduction=reduction)))(
        jnp.asarray(prediction))
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-6)
