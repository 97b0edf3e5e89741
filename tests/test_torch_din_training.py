"""The slice end to end on the CPU: DIN training, the port against JAX.

A small DIN (E=8, attention (16, 8), MLP (16, 8), 50 users, 200 items) is set
up in JAX with ``compile("adam", lr=1e-3)`` (``scripts/din_sparse_ab.py``'s
lr) and ``init_state(seed=0)``, its dense weights then scaled to N(0, 0.1)
(``WEIGHT_SCALE``), under

* ``SparseEmbeddingTrainer(packed_tables=True)``: two packed ``[V, 64]`` f32
  leaves, ``u_embeddings/embedding`` and ``i_embeddings/embedding`` (lazy
  Adam), the rest under the dense Adam; BCE on the ``[B, 2]``
  one-hot-first target, as ``scripts/din_sparse_ab.py`` compiles it, and
  BPR, DIN's ranking loss in ``scripts/quality_run.py``;
* ``QuantizedEmbeddingTrainer(packed_tables=True)``: the int8 ``i_q`` rows
  (rowwise Adagrad at the model's ``table_lr_hint``, id-keyed stochastic
  requantization salted on the path ``i_q``), the f32 user table in the dense
  Adam.

Their leaves, whole packed leaves included, load into the port's trainer
with ``params_from_jax``; both then take 5 steps on the same numpy batches of
16 rows (2 candidates, positive first; histories of 5 padded with id 0, so
the PAD row is gathered at masked steps and goes through the lazy update;
item ids skewed, so they repeat within a batch).

Tolerances (as ``tests/test_torch_deepfm_training.py``): each step's loss
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
from pytorchrec_tpu.models.din import DIN as JaxDIN
from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DIN
from pytorchrec_tpu_torch.ops.kernels.din_attention import din_attention_pool
from pytorchrec_tpu_torch.ops.kernels.quantize import requantize_rows
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

USERS, ITEMS, E, S, BATCH, N, STEPS, LR = 50, 200, 8, 5, 16, 2, 5, 1e-3
# the dense weights' N(0, 0.01) init scaled to N(0, 0.1): at 0.01 the item
# rows' gradients (three layers of 0.01 weights, over a mean of 32 scores)
# are about 1e-8, at Adam's eps, where ``m / (sqrt(v) + eps)`` turns the two
# frameworks' last-bit differences in a row's summed gradient (up to 129
# occurrences) into percents of a step: the optimizer's conditioning, not
# the port's
WEIGHT_SCALE = 10.0
SIZES = dict(emb_size=E, att_hidden_units=(16, 8), mlp_layers=(16, 8))
U, I, Q = "u_embeddings/embedding", "i_embeddings/embedding", "i_q"
KERNELS = (din_attention_pool, segmented_sum_scan, requantize_rows, scatter_set_rows)


def _columns(fc):
    col = fc.CategoricalColumnWithIdentity
    return dict(uid_column=col(feature_name="uid", category_num=USERS),
                iid_column=col(feature_name="iid", category_num=ITEMS),
                his_column=col(feature_name="pos_his", category_num=ITEMS),
                his_len_column=col(feature_name="pos_his_len", category_num=S + 1),
                label_column=col(feature_name="label", category_num=2))


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(0, S + 1, size=BATCH).astype(np.int32)
        his = np.minimum(rng.zipf(1.5, (BATCH, S)), ITEMS - 1).astype(np.int32)
        his[np.arange(S)[None, :] >= lengths[:, None]] = 0  # PAD after the history
        out.append({"uid": rng.integers(0, USERS, size=BATCH).astype(np.int32),
                    "iid": np.minimum(rng.zipf(1.5, (BATCH, N)), ITEMS - 1).astype(np.int32),
                    "pos_his": his, "pos_his_len": lengths,
                    "label": rng.integers(0, 2, size=BATCH).astype(np.int32)})
    return out


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _port_model(**kwargs):
    return DIN(**_columns(tfc), **SIZES, **kwargs, device="cpu",
               generator=torch.Generator().manual_seed(0))


def _pair(jax_cls, port_cls, batches, loss="bce", model_kwargs=(), **trainer_kwargs):
    """The JAX trainer and the port's, from the same state: JAX's initial
    tables, its attention, MLP and head weights scaled by ``WEIGHT_SCALE``."""
    model_kwargs = dict(model_kwargs)
    jax_trainer = jax_cls(JaxDIN(**_columns(jfc), **SIZES, **model_kwargs), **trainer_kwargs)
    jax_trainer.compile(optimizer="adam", lr=LR, loss=loss, metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    flat = {k: v * np.float32(WEIGHT_SCALE) if k.split("/")[0] in ("attention", "mlp", "head")
            else v for k, v in _flat(jax_trainer.state.params).items()}
    params = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                           for k, v in flat.items()})
    jax_trainer.state = jax_trainer.state.replace(params=params)
    port = port_cls(_port_model(**model_kwargs), device="cpu", **trainer_kwargs)
    port.compile(optimizer="adam", lr=LR, loss=loss)
    port.init_state(batches[0], seed=0)
    params_from_jax(flat, port)
    return jax_trainer, port


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


def _assert_scores_match(jax_trainer, port):
    serve_batch = {k: v for k, v in _batches(1, seed=7)[0].items() if k != "label"}
    want = np.asarray(jax_trainer.make_serving_fn()(serve_batch))
    got = port.make_serving_fn()(serve_batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def _touched_items(batches):
    touched = np.zeros(ITEMS, bool)
    for batch in batches:
        touched[batch["iid"].reshape(-1)] = True
        touched[batch["pos_his"].reshape(-1)] = True
    return touched


@pytest.mark.parametrize("loss", ["bce", "bpr"])
def test_five_packed_train_steps_match_jax(loss):
    batches = _batches()
    assert (np.stack([b["pos_his"] for b in batches]) == 0).any()  # PAD ids are gathered
    jax_trainer, port = _pair(SparseEmbeddingTrainer, TorchSparseTrainer, batches, loss=loss,
                              packed_tables=True)
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
    touched = torch.from_numpy(_touched_items(batches))
    items = port.state.packed[I]
    assert torch.equal(items[~touched], start[I][~touched])  # lazy: untouched rows stay
    assert touched[0] and not torch.equal(items[0], start[I][0])  # the PAD row trains
    # the model reads both tables through views of the packed buffers
    assert port.model.i_embeddings.embedding.data_ptr() == items.data_ptr()
    assert port.model.u_embeddings.embedding.data_ptr() == port.state.packed[U].data_ptr()
    _assert_dense_match(port, flat)
    _assert_scores_match(jax_trainer, port)


def test_five_int8_packed_train_steps_match_jax():
    batches = _batches()
    int8 = {"quantized_table": True}
    jax_trainer, port = _pair(QuantizedEmbeddingTrainer, TorchQuantizedTrainer, batches,
                              model_kwargs=int8, packed_tables=True)
    assert port._table_lr == 2e-2  # the model's table_lr_hint, as in JAX
    assert list(port.state.packed) == [Q]
    assert any(p is port.model.u_embeddings.embedding
               for group in port.state.optimizer.param_groups for p in group["params"])
    packed = port.state.packed[Q]
    start = packed.clone()
    _step_both(jax_trainer, port, batches)
    assert port.state.packed[Q].data_ptr() == packed.data_ptr() == port.model.i_q.data_ptr()

    flat = _flat(jax_trainer.state.params)
    touched = _touched_items(batches)
    assert torch.equal(packed[torch.from_numpy(~touched)], start[torch.from_numpy(~touched)])
    (gq, gs, ga), (wq, ws, wa) = (port.unpacked_quantized()["i"],
                                  jqp.unpack_quantized_table(flat[Q], E, 8, 1))
    gq, gs, ga = (np.asarray(a)[touched] for a in (gq, gs, ga))
    wq, ws, wa = (np.asarray(a)[touched] for a in (wq, ws, wa))
    diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000), diff.sum()
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ga, wa, rtol=1e-4, atol=1e-6)
    assert float(ga.min()) > 0.0  # every touched row took a step, PAD's included
    _assert_dense_match(port, flat, skip=(Q,), **int8)
    _assert_scores_match(jax_trainer, port)


def test_fit_steps_and_unpacked_params_after_training():
    batches = _batches(4)
    jax_trainer, port = _pair(SparseEmbeddingTrainer, TorchSparseTrainer, batches,
                              packed_tables=True)
    want = jax_trainer.fit_steps(iter(batches), steps=4, log_every=2, verbose=0)
    got = port.fit_steps(iter(batches), steps=4, log_every=2)
    assert got.epoch == [0, 1] and port.state.step == 4
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=1e-5)
    params = port.unpacked_params()
    assert params["i_embeddings.embedding"].shape == (ITEMS, E)
    assert torch.equal(params["i_embeddings.embedding"], port.state.packed[I][:, :E])
