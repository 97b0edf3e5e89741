"""``fit_steps(steps_per_call=K)`` of the port against the JAX trainer's, on
the CPU.

A small DCN-v2 (3 sparse fields of vocab 50, E=8, 2 dense fields, 2 cross
layers, MLP (8,)) trains 7 steps of 128-row numpy batches (ids repeat) with
``log_every=3`` and K = 1 and 3 (so a call of 1 step ends the run), in
three table formats: packed f32 rows under lazy Adam
(``SparseEmbeddingTrainer(packed_tables=True)``), packed int8 rows and the
classic int8 rows (``QuantizedEmbeddingTrainer``), both under rowwise
Adagrad with the id-keyed stochastic rounding. The JAX trainer runs
``fit_steps(..., steps_per_call=K, verbose=0)`` (``lax.scan`` over packed
batches); the port loads the JAX leaves with ``params_from_jax`` and runs
its own, which on the CPU runs the steps of each call eagerly over the
packed static buffers that a CUDA graph reads on the card.

Tolerances (``ROADMAP.md``'s parity rule, rel 1e-4 after N steps): the
logged losses rtol 1e-5; the f32 table's moments, int8 scale and
accumulator rtol 1e-4 / atol 1e-6, q values off by at most one in at most
0.1% of them (f32 sums of duplicate ids' grads run in another order). The
values that Adam moves (the f32 table's rows, every dense parameter): rtol
1e-4 and atol N * 1e-4 * lr (7e-6). Adam moves a value by about lr a step
whatever its gradient's scale, so gradients that agree to rel 1e-4 give
moves that agree to about 1e-4 lr a step, and a value that 7 steps moved
across zero cannot agree to rel 1e-4 of what is left of it. Values in
Adam's eps window (``sqrt(v_hat) < 1e-6``: a gradient that summed to
nearly nothing, where the last bits of the sum set the step) agree within N
lr (``chip_smoke.py::adam_values_agree`` holds them to 2.01 lr for one
step). What the wider atol covers: one value, a row of the f32 table
(1 of its 1200 values, at k = 1 and 3) that 7 steps left at about 9.6e-4,
off JAX's by 2.8e-6 where rtol 1e-4 / atol 1e-6 allow 1.1e-6; the dense
parameters and the int8 and classic runs need none of it. It is drift, not
a fault of the step: ``tests/test_torch_fit_steps_stepped.py`` takes each
of the 7 steps from JAX's state and holds every value it moves to rtol
1e-4 / atol 1e-6. The per-step scalars the port writes for the device are bit-equal
to the eager step's host values.
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
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu.training.trainer import Trainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2 as TorchDCNv2
from pytorchrec_tpu_torch.ops.kernels.quantize import table_rounding_salt
from pytorchrec_tpu_torch.ops.sparse_update import _bias_correction
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH, E, LR = 50, 3, 2, 128, 8, 1e-2
STEPS, LOG_EVERY = 7, 3
COMMON = dict(emb_size=E, num_cross_layers=2, layers=(8,))
FORMATS = {"f32": dict(unified_embedding=True),
           "int8": dict(unified_embedding=True, quantized_embedding=True, table_packed=True),
           "classic": dict(unified_embedding=True, quantized_embedding=True)}
TABLES = {"f32": "unified_emb/embedding", "int8": "unified_q", "classic": "unified_q"}


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {f"c_{i}": np.minimum(rng.zipf(1.5, BATCH) - 1, VOCAB - 1).astype(np.int64)
                 for i in range(N_SPARSE)}
        batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32)
                      for i in range(N_DENSE)})
        batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
        out.append(batch)
    return out


def _jax_model(table):
    return DCNv2(
        sparse_columns=tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                           category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        **FORMATS[table], **COMMON)


def _port_model(table):
    return TorchDCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        device="cpu", generator=torch.Generator().manual_seed(0), **FORMATS[table], **COMMON)


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _port(table, flat, batch):
    if table == "f32":
        trainer = TorchSparseTrainer(_port_model(table), device="cpu", packed_tables=True)
    else:
        trainer = TorchQuantizedTrainer(_port_model(table), device="cpu",
                                        packed_tables=table == "int8")
    trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    trainer.init_state(batch, seed=0)
    return params_from_jax(flat, trainer)


def _pair(table, batches):
    if table == "f32":
        jax_trainer = SparseEmbeddingTrainer(_jax_model(table), packed_tables=True)
    else:
        jax_trainer = QuantizedEmbeddingTrainer(_jax_model(table),
                                                packed_tables=table == "int8")
    jax_trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    return jax_trainer, _port(table, _flat(jax_trainer.state.params), batches[0])


ADAM_B2, EPS_WINDOW = 0.999, 1e-6


def _assert_adam_close(label, got, want, v):
    """Adam-moved values after STEPS steps; ``v`` their second moments."""
    got, want, v = (np.asarray(a, dtype=np.float64) for a in (got, want, v))
    window = np.sqrt(v / (1.0 - ADAM_B2 ** STEPS)) < EPS_WINDOW
    err = np.abs(got - want)
    bad = ~window & (err > 1e-4 * np.abs(want) + STEPS * 1e-4 * LR)
    assert not bad.any(), f"{label}: {int(bad.sum())} values, max abs err {err[bad].max()}"
    assert (err[window] <= STEPS * LR).all(), f"{label}: a value in the eps window"


def _assert_q_close(got_q, want_q):
    diff = np.abs(np.asarray(got_q).astype(np.int32) - np.asarray(want_q).astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000), diff.sum()


def _assert_tables_match(table, jax_trainer, port):
    flat = _flat(jax_trainer.state.params)
    if table == "f32":
        got, want = port.state.packed[TABLES[table]].numpy(), flat[TABLES[table]]
        _assert_adam_close("table", got[:, :E], want[:, :E], want[:, 2 * E:3 * E])
        np.testing.assert_allclose(got[:, E:], want[:, E:], rtol=1e-4, atol=1e-6)
        return
    if table == "int8":
        got_q, got_scale, got_acc = port.unpacked_quantized()["unified"]
        want_q, want_scale, want_acc = jqp.unpack_quantized_table(flat["unified_q"], E)
    else:
        got_q, got_scale = port.model.unified_q, port.model.unified_scale
        got_acc = port.state.table_acc["unified"]
        want_q, want_scale = flat["unified_q"], flat["unified_scale"]
        want_acc = np.asarray(jax_trainer.state.table_acc["unified"])
    _assert_q_close(got_q.numpy(), want_q)
    np.testing.assert_allclose(got_scale.numpy(), np.asarray(want_scale), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_acc), rtol=1e-4, atol=1e-6)


def _assert_dense_match(table, jax_trainer, port):
    flat = _flat(jax_trainer.state.params)
    want = params_from_jax(flat, _port_model(table)).state_dict()
    moments = port.state.optimizer.state
    for key, param in port.model.named_parameters():
        if param in moments:
            _assert_adam_close(key, param.detach().numpy(), want[key].numpy(),
                               moments[param]["exp_avg_sq"].numpy())


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("table", ["f32", "int8", "classic"])
def test_fit_steps_per_call_matches_jax(table, k):
    batches = _batches()
    jax_trainer, port = _pair(table, batches)
    want = jax_trainer.fit_steps(iter(batches), steps=STEPS, log_every=LOG_EVERY,
                                 steps_per_call=k, verbose=0)
    got = port.fit_steps(iter(batches), steps=STEPS, log_every=LOG_EVERY, steps_per_call=k)
    assert len(got.history["loss"]) == len(want.history["loss"]) == 3  # after 3, 6, 7
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=1e-5)
    assert port.state.step == int(jax_trainer.state.step) == STEPS
    assert port.step_losses.shape == (STEPS,)
    np.testing.assert_array_equal(port.step_losses.numpy()[[2, 5, 6]], got.history["loss"])
    _assert_tables_match(table, jax_trainer, port)
    _assert_dense_match(table, jax_trainer, port)


@pytest.mark.parametrize("table", ["f32", "int8", "classic"])
def test_fit_steps_runs_the_eager_step_over_packed_buffers(table):
    """On the CPU a call's steps are the eager step's arithmetic over the
    packed static buffers (int32 ids, as the packer casts them): the same
    losses and tables, bit for bit, as ``train_step`` on the batches."""
    batches = _batches()
    flat = _flat(_pair(table, batches)[0].state.params)
    eager, fused = (_port(table, flat, batches[0]) for _ in range(2))
    losses = torch.stack([eager.train_step(b) for b in batches])
    fused.fit_steps(iter(batches), steps=STEPS, log_every=LOG_EVERY, steps_per_call=3)
    assert torch.equal(fused.step_losses, losses)
    for (key, want), got in zip(eager.model.state_dict().items(),
                                fused.model.state_dict().values()):
        assert torch.equal(got, want), key
    for key, want in eager.state.packed.items():
        assert torch.equal(fused.state.packed[key], want), key
    for key, want in getattr(eager.state, "table_acc", {}).items():
        assert torch.equal(fused.state.table_acc[key], want), key


@pytest.mark.parametrize("table", ["f32", "int8"])
def test_step_scalars_are_the_eager_host_values(table):
    """Every row of the step scalars the port writes for the device: the
    1-based step, Adam's bias corrections (``_bias_correction``, numpy f32)
    and the rounding salt (``table_rounding_salt``, the JAX package's salt),
    bit for bit."""
    batches = _batches(1)
    jax_trainer, port = _pair(table, batches)
    path = TABLES[table]
    rows = port.state.scalars.host_rows(1, 9)
    assert rows.dtype == np.int32 and rows.shape == (9, port.state.scalars.width)
    view = torch.from_numpy(rows)
    for i, step in enumerate(range(1, 10)):
        assert rows[i, 0] == step
        if table == "f32":
            got = port.state.scalars.bias_correction(view[i], path).numpy()
            want = np.array([_bias_correction(0.9, step), _bias_correction(0.999, step)],
                            np.float32)
            assert got.tobytes() == want.tobytes()
        else:
            got = int(port.state.scalars.salt(view[i], path).numpy().view(np.uint32)[0])
            assert got == table_rounding_salt(port.state.rng_key, step, path)
            assert got == int(jq.table_rounding_salt(jax_trainer.state.rng, np.int32(step),
                                                     path))


def test_steps_per_call_needs_packed_transfer():
    batches = _batches(2)
    jax_trainer = Trainer(_jax_model("f32"), packed_transfer=False)
    jax_trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    with pytest.raises(AssertionError, match="packed_transfer"):
        jax_trainer.fit_steps(iter(batches), steps=2, steps_per_call=2, verbose=0)
    port = TorchTrainer(_port_model("f32"), device="cpu", packed_transfer=False)
    port.compile(optimizer="adam", lr=LR, loss="bce")
    with pytest.raises(ValueError, match="packed_transfer"):
        port.fit_steps(iter(batches), steps=2, steps_per_call=2)
    assert TorchTrainer(_port_model("f32"), device="cpu").packed_transfer  # the default
    history = port.fit_steps(iter(batches), steps=2, log_every=1)  # unpacked, one step a call
    assert len(history.history["loss"]) == 2 and port.state.step == 2
