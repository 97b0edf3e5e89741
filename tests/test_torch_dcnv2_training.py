"""The slice end to end on the CPU: DCN-v2 training with packed f32 tables,
the port against JAX.

A small DCN-v2 (3 sparse fields of vocab 50, E=4, 2 dense fields, 2 cross
layers, MLP (8,)) is set up in JAX under
``SparseEmbeddingTrainer(packed_tables=True)`` with
``compile("adam", lr=1e-2, loss="bce")`` and ``init_state(seed=0)``; its
leaves (the whole packed ``[V, 64]`` table leaf included) load into the
port's trainer with ``params_from_jax``. Both then take 5 steps on the same
numpy batches of 64 rows, whose ids repeat in runs longer than 8 (the JAX
scan's cond tail fires). Tolerances: each step's loss rtol 1e-5; the packed
leaf and every dense parameter after 5 steps rtol 1e-4 / atol 1e-6; scores
after training rtol 1e-4 / atol 1e-6. f32 sums run in another order in the two
frameworks, and Adam's update divides by small second moments.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu.models import DCNv2
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu.training.trainer import Trainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2 as TorchDCNv2
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH, STEPS, LR = 50, 3, 2, 64, 5, 1e-2
COMMON = dict(emb_size=4, num_cross_layers=2, layers=(8,))
TABLE = "unified_emb/embedding"


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        # ids skewed towards a few hot values, so one id repeats 10+ times
        batch = {f"c_{i}": np.minimum(rng.zipf(1.5, BATCH) - 1, VOCAB - 1).astype(np.int32)
                 for i in range(N_SPARSE)}
        batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32)
                      for i in range(N_DENSE)})
        batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
        out.append(batch)
    return out


def _jax_model():
    return DCNv2(
        sparse_columns=tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                           category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        unified_embedding=True, **COMMON)


def _port_model():
    return TorchDCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        unified_embedding=True, device="cpu", generator=torch.Generator().manual_seed(0),
        **COMMON)


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _pair(table_optimizer, batches, table_lr=None):
    """The JAX trainer and the port's, from the same state."""
    jax_trainer = SparseEmbeddingTrainer(_jax_model(), table_optimizer=table_optimizer,
                                         packed_tables=True, table_lr=table_lr)
    jax_trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    port = TorchSparseTrainer(_port_model(), device="cpu", table_optimizer=table_optimizer,
                              packed_tables=True, table_lr=table_lr)
    port.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    port.init_state(batches[0], seed=0)
    params_from_jax(_flat(jax_trainer.state.params), port)
    return jax_trainer, port


def _assert_state_matches(jax_trainer, port):
    flat = _flat(jax_trainer.state.params)
    np.testing.assert_allclose(port.state.packed[TABLE].numpy(), flat[TABLE],
                               rtol=1e-4, atol=1e-6)
    got = port.model.state_dict()
    for key, want in params_from_jax(flat, _port_model()).state_dict().items():
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("table_optimizer,table_lr", [
    ("adam", None), ("adagrad", None), ("rowwise_adagrad", None), ("rowwise_adagrad", 3e-2)])
def test_five_packed_train_steps_match_jax(table_optimizer, table_lr):
    batches = _batches()
    jax_trainer, port = _pair(table_optimizer, batches, table_lr)
    packed = port.state.packed[TABLE]
    address = packed.data_ptr()
    before = (cross_network.launches, segmented_sum_scan.launches, scatter_set_rows.launches)
    for step, batch in enumerate(batches):
        want = float(jax_trainer._train_step(batch))
        got = port.train_step(batch)
        assert got.shape == () and port.state.step == step + 1
        np.testing.assert_allclose(float(got), want, rtol=1e-5, err_msg=f"step {step}")
    # CPU tensors run the plain versions and launch nothing
    assert (cross_network.launches, segmented_sum_scan.launches,
            scatter_set_rows.launches) == before
    assert port.state.packed[TABLE].data_ptr() == address  # updated in place
    _assert_state_matches(jax_trainer, port)

    serve_batch = {k: v for k, v in _batches(1, seed=7)[0].items() if k != "label"}
    want = np.asarray(jax_trainer.make_serving_fn()(serve_batch))
    got = port.make_serving_fn()(serve_batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)  # scores ~0.05


def test_untouched_rows_stay_bit_identical():
    batches = _batches()
    _, port = _pair("adam", batches)
    start = port.state.packed[TABLE].clone()
    for batch in batches:
        port.train_step(batch)
    touched = np.zeros(N_SPARSE * VOCAB, bool)
    for batch in batches:
        for i in range(N_SPARSE):
            touched[batch[f"c_{i}"] + i * VOCAB] = True
    after = port.state.packed[TABLE]
    assert (~touched).any()
    assert torch.equal(after[~touched], start[~touched])
    assert not torch.equal(after[touched, :4], start[touched, :4])
    assert torch.equal(after[:, 12:], torch.zeros_like(after[:, 12:]))  # staging stays zero
    # the model serves from a view of the packed buffer, not a copy
    assert port.model.unified_emb.embedding.data_ptr() == after.data_ptr()
    assert torch.equal(port.unpacked_params()["unified_emb.embedding"], after[:, :4])


def test_fit_steps_logs_the_loss_each_window():
    batches = _batches(7)
    jax_trainer, port = _pair("adam", batches)
    want = jax_trainer.fit_steps(iter(batches), steps=7, log_every=3, verbose=0)
    got = port.fit_steps(iter(batches), steps=7, log_every=3)
    assert got.epoch == [0, 1, 2] and port.state.step == 7
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=1e-5)


def test_fit_steps_initialises_state_from_the_first_batch():
    port = TorchSparseTrainer(_port_model(), device="cpu", packed_tables=True)
    port.compile(optimizer="adam", lr=LR, loss="bce")
    history = port.fit_steps(iter(_batches(2)), steps=2, log_every=5)
    assert port.state.step == 2 and len(history.history["loss"]) == 1
    assert np.isfinite(history.history["loss"][0])


@pytest.mark.parametrize("optimizer,weight_decay", [("adam", 0.0), ("adam", 1e-2),
                                                    ("sgd", 1e-2)])
def test_dense_trainer_steps_match_jax(optimizer, weight_decay):
    """The base trainer: the dense optimizer over every parameter, the table
    included, with coupled L2 decay, at bench.py's lr (Adam moves a weight
    whose gradient is near eps by up to lr either way, so a larger lr widens
    f32 differences past atol)."""
    batches = _batches(3)
    jax_trainer = Trainer(_jax_model())
    jax_trainer.compile(optimizer=optimizer, lr=1e-3, loss="bce", metrics=(),
                        weight_decay=weight_decay)
    jax_trainer.init_state(batches[0], seed=0)
    port = TorchTrainer(_port_model(), device="cpu")
    port.compile(optimizer=optimizer, lr=1e-3, loss="bce", weight_decay=weight_decay)
    port.init_state(batches[0], seed=3)
    params_from_jax(_flat(jax_trainer.state.params), port.model)
    for batch in batches:
        np.testing.assert_allclose(float(port.train_step(batch)),
                                   float(jax_trainer._train_step(batch)), rtol=1e-5)
    want = params_from_jax(_flat(jax_trainer.state.params), _port_model()).state_dict()
    for key, value in port.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_dropout_masks_follow_the_seed():
    def losses(seed):
        model = _port_model()
        model.deep.layers[0].dropout = 0.5
        trainer = TorchSparseTrainer(model, device="cpu", packed_tables=True)
        trainer.compile(optimizer="adam", lr=LR, loss="bce")
        trainer.init_state(_batches(1)[0], seed=seed)
        return [float(trainer.train_step(b)) for b in _batches(3)]

    assert losses(0) == losses(0) != losses(1)


def test_init_state_draws_from_the_seed():
    def init(seed):
        trainer = TorchSparseTrainer(_port_model(), device="cpu", packed_tables=True)
        trainer.compile(optimizer="adam", lr=LR, loss="bce")
        trainer.init_state(_batches(1)[0], seed=seed)
        return trainer.state.packed[TABLE].clone(), trainer.model.cross.ws.detach().clone()

    (t0, w0), (t1, w1), (t2, _) = init(0), init(0), init(1)
    assert torch.equal(t0, t1) and torch.equal(w0, w1) and not torch.equal(t0, t2)
    assert t0.shape == (N_SPARSE * VOCAB, 64) and torch.equal(t0[:, 4:], torch.zeros_like(t0[:, 4:]))
    assert 0.005 < float(t0[:, :4].std()) < 0.02


def test_trainer_surface_raises_on_what_is_not_ported():
    # the unpacked default, byte rows and bf16 rows build and take a step
    for kwargs in ({}, {"packed_tables": True, "packed_bytes": True},
                   {"packed_tables": True, "packed_dtype": "bfloat16"}):
        trainer = TorchSparseTrainer(_port_model(), device="cpu", **kwargs)
        trainer.compile()
        trainer.init_state(_batches(1)[0], seed=0)
        assert np.isfinite(float(trainer.train_step(_batches(1)[0]))) and trainer.state.step == 1
    model = _port_model()
    trainer = TorchSparseTrainer(model, device="cpu", packed_tables=True)
    trainer.compile(metrics=("auc",))  # ported: evaluate reports them
    assert [m.name for m in trainer.metrics.metrics] == ["auc"]
    with pytest.raises(ValueError):
        trainer.compile(metrics=("nope",))
    with pytest.raises(ValueError, match="unknown optimizer"):
        trainer.compile(optimizer="adamx")  # every name of the JAX registry is ported
    with pytest.raises(RuntimeError):
        trainer.train_step(_batches(1)[0])  # not compiled
    trainer.compile()
    with pytest.raises(RuntimeError):
        trainer.train_step(_batches(1)[0])  # no state
    history = trainer.fit_steps(iter(_batches(1)), steps=1, callbacks=[])  # ported: the fit loop
    assert len(history.history["loss"]) == 1 and trainer.state.step == 1
    trainer.init_state(_batches(1)[0], seed=0)
    trainer.train_step(_batches(1)[0])
    with pytest.raises(ValueError):
        params_from_jax({}, trainer)  # after a step
