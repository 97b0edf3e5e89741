"""The slice end to end on the CPU: DCN-v2 training with packed quantized
tables, the port against JAX.

A small DCN-v2 (3 sparse fields of vocab 50, E=4, 2 dense fields, 2 cross
layers, MLP (8,)) with a packed int8 or int4 table is set up in JAX under
``QuantizedEmbeddingTrainer(packed_tables=True)`` with
``compile("adam", lr=1e-2, loss="bce")`` and ``init_state(seed=0)``; its
leaves (the whole packed ``unified_q`` leaf included) load into the port's
trainer with ``params_from_jax``. Both then take 5 steps on the same numpy
batches of 64 rows, whose ids repeat. The port derives each step's rounding
salt from its own copy of the JAX state's key.

Tolerances: each step's loss rtol 1e-5; after 5 steps the touched rows'
scale and accumulator rtol 1e-4 / atol 1e-6 and their q values off by at
most one in at most 0.1% of them (at least one): f32 sums run in another
order in the two frameworks (the dense layers' products, the duplicate ids'
grads), and a q value moves by one where that puts ``row / scale + u`` on
the other side of an integer. Untouched rows stay bit-identical; scores
after training rtol 1e-4 / atol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu.models import DCNv2
from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu.ops.kernels import quantize as jq
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2 as TorchDCNv2
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.ops.kernels.quantize import requantize_rows, table_rounding_salt
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH, STEPS, LR, E = 50, 3, 2, 64, 5, 1e-2, 4
COMMON = dict(emb_size=E, num_cross_layers=2, layers=(8,))
TABLE = "unified_q"
FORMATS = [(8, 1), (4, 1), (8, 2)]
KERNELS = (cross_network, segmented_sum_scan, requantize_rows, scatter_set_rows)


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {f"c_{i}": np.minimum(rng.zipf(1.5, BATCH) - 1, VOCAB - 1).astype(np.int32)
                 for i in range(N_SPARSE)}
        batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32)
                      for i in range(N_DENSE)})
        batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
        out.append(batch)
    return out


def _quant(bits, groups):
    return dict(unified_embedding=True, quantized_embedding=True, table_packed=True,
                table_bits=bits, scale_col_groups=groups)


def _jax_model(bits, groups):
    return DCNv2(
        sparse_columns=tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                           category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        **_quant(bits, groups), **COMMON)


def _port_model(bits, groups, **overrides):
    kwargs = {**_quant(bits, groups), **overrides}
    return TorchDCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        device="cpu", generator=torch.Generator().manual_seed(0), **kwargs, **COMMON)


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _pair(bits, groups, batches):
    jax_trainer = QuantizedEmbeddingTrainer(_jax_model(bits, groups), packed_tables=True)
    jax_trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    port = TorchQuantizedTrainer(_port_model(bits, groups), device="cpu", packed_tables=True)
    port.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    port.init_state(batches[0], seed=0)
    params_from_jax(_flat(jax_trainer.state.params), port)
    return jax_trainer, port


def _touched(batches):
    touched = np.zeros(N_SPARSE * VOCAB, bool)
    for batch in batches:
        for i in range(N_SPARSE):
            touched[batch[f"c_{i}"] + i * VOCAB] = True
    return touched


def _assert_triples_match(got, want, bits, rows):
    """(q, scale, acc) of the port against JAX's on ``rows``."""
    gq, gs, ga = (np.asarray(a)[rows] for a in got)
    wq, ws, wa = (np.asarray(a)[rows] for a in want)
    if bits == 4:
        gq, wq = (np.asarray(jq.unpack_int4(a)) for a in (gq, wq))
    diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000), diff.sum()
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ga, wa, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bits,groups", FORMATS)
def test_five_int8_packed_train_steps_match_jax(bits, groups):
    batches = _batches()
    jax_trainer, port = _pair(bits, groups, batches)
    np.testing.assert_array_equal(port.state.rng_key,
                                  np.asarray(jax.random.key_data(jax_trainer.state.rng)))
    packed = port.state.packed[TABLE]
    assert packed.data_ptr() == port.model.unified_q.data_ptr()  # the model's own buffer
    start = packed.clone()
    before = [k.launches for k in KERNELS]
    for step, batch in enumerate(batches):
        want_salt = int(jq.table_rounding_salt(jax_trainer.state.rng,
                                               jax_trainer.state.step + 1, TABLE))
        assert table_rounding_salt(port.state.rng_key, step + 1, TABLE) == want_salt
        want = float(jax_trainer._train_step(batch))
        got = port.train_step(batch)
        assert got.shape == () and port.state.step == step + 1
        np.testing.assert_allclose(float(got), want, rtol=1e-5, err_msg=f"step {step}")
    assert [k.launches for k in KERNELS] == before  # the CPU runs the plain versions
    assert port.state.packed[TABLE].data_ptr() == packed.data_ptr()  # updated in place

    flat = _flat(jax_trainer.state.params)
    touched = _touched(batches)
    after = port.state.packed[TABLE]
    assert torch.equal(after[torch.from_numpy(~touched)], start[torch.from_numpy(~touched)])
    base = 4 + 4 * groups + 4 if bits == 8 else 2 + 4 * groups + 4
    assert not after[:, base:].any()  # staging and pad stay zero
    want_triple = jqp.unpack_quantized_table(flat[TABLE], E, bits, groups)
    got_triple = port.unpacked_quantized()["unified"]
    _assert_triples_match(got_triple, want_triple, bits, touched)
    jax_unpacked = jax_trainer.unpacked_quantized()["unified"]
    _assert_triples_match(got_triple, jax_unpacked, bits, slice(None))
    assert float(got_triple[2][touched].min()) > 0.0  # every touched row took a step

    dense = params_from_jax(flat, _port_model(bits, groups)).state_dict()
    for key, value in port.model.state_dict().items():
        if key != TABLE:
            np.testing.assert_allclose(value.numpy(), dense[key].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=key)

    serve_batch = {k: v for k, v in _batches(1, seed=7)[0].items() if k != "label"}
    want = np.asarray(jax_trainer.make_serving_fn()(serve_batch))
    got = port.make_serving_fn()(serve_batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_fit_steps_logs_the_loss_each_window():
    batches = _batches(7)
    jax_trainer, port = _pair(8, 1, batches)
    want = jax_trainer.fit_steps(iter(batches), steps=7, log_every=3, verbose=0)
    got = port.fit_steps(iter(batches), steps=7, log_every=3)
    assert got.epoch == [0, 1, 2] and port.state.step == 7
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=1e-5)


def test_init_state_draws_the_table_from_the_seed():
    def init(seed):
        trainer = TorchQuantizedTrainer(_port_model(8, 1), device="cpu", packed_tables=True)
        trainer.compile(optimizer="adam", lr=LR, loss="bce")
        trainer.init_state(_batches(1)[0], seed=seed)
        return trainer

    a, b, c = init(0), init(0), init(1)
    table = a.state.packed[TABLE]
    assert torch.equal(table, b.state.packed[TABLE])
    assert not torch.equal(table, c.state.packed[TABLE])
    q, scale, acc = a.unpacked_quantized()["unified"]
    assert table.shape == (N_SPARSE * VOCAB, 64) and not acc.any() and not table[:, 12:].any()
    rows = q.float() * scale[:, None]
    assert 0.005 < float(rows.std()) < 0.02  # normal(0, 0.01) rows, quantized
    assert not np.array_equal(a.state.rng_key, c.state.rng_key)


def test_table_lr_resolves_from_the_model():
    trainer = TorchQuantizedTrainer(_port_model(8, 1), device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=3e-3, loss="bce")
    assert trainer._table_lr == 3e-3  # DCN-v2 declares table_lr_shared_ok
    trainer = TorchQuantizedTrainer(_port_model(8, 1), device="cpu", packed_tables=True,
                                    table_lr=0.05)
    trainer.compile(optimizer="adam", lr=3e-3, loss="bce")
    assert trainer._table_lr == 0.05


def test_mismatched_tables_and_trainers_raise():
    batch = _batches(1)[0]
    model = _port_model(8, 1)
    classic = TorchQuantizedTrainer(model, device="cpu", packed_tables=False)
    classic.compile(optimizer="adam", lr=LR, loss="bce")
    with pytest.raises(ValueError, match="must agree"):  # a packed model, a classic trainer
        classic.init_state(batch, seed=0)
    trainer = TorchQuantizedTrainer(model, device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=LR, loss="bce")
    model.table_packed = False  # the model now reports unpacked rows
    with pytest.raises(ValueError, match="must agree"):
        trainer.init_state(batch, seed=0)
    f32_model = _port_model(8, 1, quantized_embedding=False, table_packed=False)
    trainer = TorchQuantizedTrainer(f32_model, device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=LR, loss="bce")
    with pytest.raises(ValueError):
        trainer.init_state(batch, seed=0)
    for other in (TorchSparseTrainer(_port_model(8, 1), device="cpu", packed_tables=True),
                  TorchTrainer(_port_model(8, 1), device="cpu")):
        other.compile(optimizer="adam", lr=LR, loss="bce")
        with pytest.raises(ValueError):
            other.init_state(batch, seed=0)
