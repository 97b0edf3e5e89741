"""The slice end to end on the CPU: LR, FM and DeepFM training, the port
against JAX.

Small models (3 sparse fields of vocab 50, E=4, 2 dense fields, DeepFM's MLP
(8,)) are set up in JAX with ``compile("adam", lr=1e-2, loss="bce")`` and
``init_state(seed=0)`` under

* ``SparseEmbeddingTrainer(packed_tables=True)``: two packed ``[V, 64]``
  leaves, ``unified_emb/embedding`` (E=4) and ``unified_lin/embedding``
  (E=1, 4 of its 64 columns under Adam), for adam, adagrad and
  rowwise_adagrad; LR with its linear table alone;
* ``QuantizedEmbeddingTrainer(packed_tables=True)``: DeepFM's int8
  ``unified_q`` rows, with the f32 ``unified_lin`` in the dense Adam;
* the dense ``Trainer``: FM, every parameter under Adam.

Their leaves (whole packed leaves included) load into the port's trainer
with ``params_from_jax``; both then take 5 steps on the same numpy batches
of 64 rows, whose ids repeat in runs longer than 8. The batches come from
seed 2: under seed 0 one id's summed gradient in the FM models cancels to
4e-9 out of terms near 1e-4, right at Adam's eps, where the optimizer's
``g / (|g| + eps)`` turns the frameworks' last-bit differences into half a
percent of a step (and seed 1 has a similar case); that is the optimizer's
conditioning, not the port's.

Tolerances (as ``tests/test_torch_dcnv2_training.py``): each step's loss
rtol 1e-5; every packed leaf and dense parameter after 5 steps rtol 1e-4 /
atol 1e-6; int8 rows' scale and accumulator so, their q values off by at
most one in at most 0.1% of them; scores after training rtol 1e-4 / atol
1e-6. f32 sums run in another order in the two frameworks, and Adam's
update divides by small second moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu import models as jmodels
from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu.ops import sparse_update as jsu
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu.training.trainer import Trainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch import models as tmodels
from pytorchrec_tpu_torch.ops.kernels import fm as fm_kernels
from pytorchrec_tpu_torch.ops.kernels.quantize import requantize_rows
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.ops.sparse_update import packed_sparse_update
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH, STEPS, LR, E = 50, 3, 2, 64, 5, 1e-2, 4
EMB, LIN, Q = "unified_emb/embedding", "unified_lin/embedding", "unified_q"
EXTRA = {"LR": {}, "FM": {}, "DeepFM": {"layers": (8,)}}
KERNELS = (fm_kernels.fm_interaction, fm_kernels.fm_interaction_backward, segmented_sum_scan,
           requantize_rows, scatter_set_rows)
INT8 = dict(quantized_embedding=True, table_packed=True)


def _batches(n=STEPS, seed=2):
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


def _columns(fc):
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


def _jax_model(name, **kwargs):
    return getattr(jmodels, name)(**_columns(jfc), emb_size=E, unified_embedding=True,
                                  **EXTRA[name], **kwargs)


def _port_model(name, **kwargs):
    return getattr(tmodels, name)(**_columns(tfc), emb_size=E, unified_embedding=True,
                                  device="cpu", generator=torch.Generator().manual_seed(0),
                                  **EXTRA[name], **kwargs)


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _pair(jax_cls, port_cls, name, batches, model_kwargs=(), **trainer_kwargs):
    """The JAX trainer and the port's, from the same state."""
    model_kwargs = dict(model_kwargs)
    jax_trainer = jax_cls(_jax_model(name, **model_kwargs), **trainer_kwargs)
    jax_trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    port = port_cls(_port_model(name, **model_kwargs), device="cpu", **trainer_kwargs)
    port.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    port.init_state(batches[0], seed=0)
    params_from_jax(_flat(jax_trainer.state.params), port)
    return jax_trainer, port


def _step_both(jax_trainer, port, batches):
    before = [k.launches for k in KERNELS]
    for step, batch in enumerate(batches):
        want = float(jax_trainer._train_step(batch))
        got = port.train_step(batch)
        assert got.shape == () and port.state.step == step + 1
        np.testing.assert_allclose(float(got), want, rtol=1e-5, err_msg=f"step {step}")
    assert [k.launches for k in KERNELS] == before  # the CPU runs the plain versions


def _assert_dense_match(port, flat, name, skip=(), **model_kwargs):
    want = params_from_jax(flat, _port_model(name, **model_kwargs)).state_dict()
    for key, value in port.model.state_dict().items():
        if key not in skip:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)


def _assert_scores_match(jax_trainer, port):
    serve_batch = {k: v for k, v in _batches(1, seed=7)[0].items() if k != "label"}
    want = np.asarray(jax_trainer.make_serving_fn()(serve_batch))
    got = port.make_serving_fn()(serve_batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def _touched(batches):
    touched = np.zeros(N_SPARSE * VOCAB, bool)
    for batch in batches:
        for i in range(N_SPARSE):
            touched[batch[f"c_{i}"] + i * VOCAB] = True
    return touched


@pytest.mark.parametrize("table_optimizer", ["adam", "adagrad", "rowwise_adagrad"])
@pytest.mark.parametrize("name", ["DeepFM", "FM"])
def test_five_packed_train_steps_match_jax(name, table_optimizer):
    batches = _batches()
    jax_trainer, port = _pair(SparseEmbeddingTrainer, TorchSparseTrainer, name, batches,
                              table_optimizer=table_optimizer, packed_tables=True)
    assert sorted(port.state.packed) == [EMB, LIN]
    assert port.state.packed[LIN].shape == (N_SPARSE * VOCAB, 64)  # packed_width(1, ...)
    addresses = {path: t.data_ptr() for path, t in port.state.packed.items()}
    start = {path: t.clone() for path, t in port.state.packed.items()}
    _step_both(jax_trainer, port, batches)
    assert {path: t.data_ptr() for path, t in port.state.packed.items()} == addresses

    flat = _flat(jax_trainer.state.params)
    for path in (EMB, LIN):
        np.testing.assert_allclose(port.state.packed[path].numpy(), flat[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)
    touched = torch.from_numpy(_touched(batches))
    lin = port.state.packed[LIN]
    assert torch.equal(lin[~touched], start[LIN][~touched])  # lazy: untouched rows stay
    assert not torch.equal(lin[touched, :1], start[LIN][touched, :1])
    assert not lin[:, 4:].any()  # 3 adam columns + 1 staging column; the rest stay zero
    # the model reads both tables through views of the packed buffers
    assert port.model.unified_lin.embedding.data_ptr() == lin.data_ptr()
    assert port.model.unified_emb.embedding.data_ptr() == port.state.packed[EMB].data_ptr()
    _assert_dense_match(port, flat, name)
    _assert_scores_match(jax_trainer, port)


def test_lr_trains_its_linear_table_alone():
    batches = _batches()
    jax_trainer, port = _pair(SparseEmbeddingTrainer, TorchSparseTrainer, "LR", batches,
                              packed_tables=True)
    assert list(port.state.packed) == [LIN]
    _step_both(jax_trainer, port, batches)
    flat = _flat(jax_trainer.state.params)
    assert "dense_factors" in flat and EMB not in flat  # declared by JAX's LR, never read
    np.testing.assert_allclose(port.state.packed[LIN].numpy(), flat[LIN], rtol=1e-4, atol=1e-6)
    _assert_dense_match(port, flat, "LR")
    _assert_scores_match(jax_trainer, port)


def test_five_int8_packed_train_steps_match_jax():
    """DeepFM's int8 rows under rowwise Adagrad with stochastic
    requantization; its f32 linear table, ``dense_factors``,
    ``dense_linear`` and ``bias`` under the dense Adam."""
    batches = _batches()
    jax_trainer, port = _pair(QuantizedEmbeddingTrainer, TorchQuantizedTrainer, "DeepFM",
                              batches, model_kwargs=INT8, packed_tables=True)
    assert list(port.state.packed) == [Q]
    assert any(p is port.model.unified_lin.embedding
               for group in port.state.optimizer.param_groups for p in group["params"])
    packed = port.state.packed[Q]
    start = packed.clone()
    _step_both(jax_trainer, port, batches)
    assert port.state.packed[Q].data_ptr() == packed.data_ptr() == port.model.unified_q.data_ptr()

    flat = _flat(jax_trainer.state.params)
    touched = _touched(batches)
    assert torch.equal(packed[torch.from_numpy(~touched)], start[torch.from_numpy(~touched)])
    (gq, gs, ga), (wq, ws, wa) = (
        port.unpacked_quantized()["unified"],
        jqp.unpack_quantized_table(flat[Q], E, 8, 1))
    gq, gs, ga = (np.asarray(a)[touched] for a in (gq, gs, ga))
    wq, ws, wa = (np.asarray(a)[touched] for a in (wq, ws, wa))
    diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000), diff.sum()
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ga, wa, rtol=1e-4, atol=1e-6)
    assert float(ga.min()) > 0.0  # every touched row took a step
    # the dense Adam moved every row of the linear table (zero grads decay the moments)
    _assert_dense_match(port, flat, "DeepFM", skip=(Q,), **INT8)
    _assert_scores_match(jax_trainer, port)


def test_dense_trainer_steps_match_jax():
    """FM under the base trainer: the dense Adam over every parameter, both
    tables included, at bench.py's lr (a larger lr widens f32 differences
    past atol, as for DCN-v2)."""
    batches = _batches(3)
    jax_trainer = Trainer(_jax_model("FM"))
    jax_trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    port = TorchTrainer(_port_model("FM"), device="cpu")
    port.compile(optimizer="adam", lr=1e-3, loss="bce")
    port.init_state(batches[0], seed=3)
    params_from_jax(_flat(jax_trainer.state.params), port.model)
    for batch in batches:
        np.testing.assert_allclose(float(port.train_step(batch)),
                                   float(jax_trainer._train_step(batch)), rtol=1e-5)
    _assert_dense_match(port, _flat(jax_trainer.state.params), "FM")


def test_fit_steps_and_serving_after_training():
    batches = _batches(7)
    jax_trainer, port = _pair(SparseEmbeddingTrainer, TorchSparseTrainer, "DeepFM", batches,
                              packed_tables=True)
    want = jax_trainer.fit_steps(iter(batches), steps=7, log_every=3, verbose=0)
    got = port.fit_steps(iter(batches), steps=7, log_every=3)
    assert got.epoch == [0, 1, 2] and port.state.step == 7
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=1e-5)
    params = port.unpacked_params()
    assert params["unified_lin.embedding"].shape == (N_SPARSE * VOCAB, 1)
    assert torch.equal(params["unified_lin.embedding"], port.state.packed[LIN][:, :1])


@pytest.mark.parametrize("table_optimizer", ["adam", "adagrad", "rowwise_adagrad"])
def test_packed_update_of_a_one_column_table_matches_jax(table_optimizer):
    """The linear table's update alone: E=1 rows packed to 64 columns, the
    one staging column scanned through the row stride, against the JAX
    package's ``packed_sparse_update`` (rtol 1e-5 / atol 1e-7: one step, the
    same scan order, f32 arithmetic in another framework)."""
    rng = np.random.default_rng(11)
    vocab, n = 40, 300
    table = (rng.normal(size=(vocab, 1)) * 0.01).astype(np.float32)
    packed = np.array(jsu.pack_table(jnp.asarray(table), table_optimizer))
    packed[:, 1:3] = np.abs(rng.normal(size=(vocab, 2)).astype(np.float32)) * 1e-3  # moments
    packed[:, 3:] = 0.0
    ids = np.minimum(rng.zipf(1.3, n) - 1, vocab - 1).astype(np.int32)
    dvec = rng.normal(size=(n, 1)).astype(np.float32)
    want = jsu.packed_sparse_update(jnp.asarray(packed), jnp.asarray(packed[ids]),
                                    jnp.asarray(ids), jnp.asarray(dvec), jnp.asarray(3, jnp.int32),
                                    lr=1e-2, optimizer=table_optimizer)
    got = torch.from_numpy(packed.copy())
    before = (segmented_sum_scan.launches, scatter_set_rows.launches)
    packed_sparse_update(got, got[torch.from_numpy(ids).long()], torch.from_numpy(ids),
                         torch.from_numpy(dvec), 3, lr=1e-2, optimizer=table_optimizer)
    assert (segmented_sum_scan.launches, scatter_set_rows.launches) == before
    assert packed.shape == (vocab, 64) and np.isin(np.arange(vocab), ids).sum() < vocab
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
