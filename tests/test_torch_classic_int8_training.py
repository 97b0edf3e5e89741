"""The classic quantized-row step (``packed_tables=False``) end to end on the
CPU: DCN-v2, DeepFM and FM training, the port against JAX.

Small models (3 sparse fields of vocab 50, E=4, 2 dense fields, DCN-v2's 2
cross layers and MLP (8,), DeepFM's MLP (8,)) with the classic int8 table,
the int4 one and two scale groups are set up in JAX under
``QuantizedEmbeddingTrainer()`` with ``compile("adam", lr=1e-2,
loss="bce")`` and ``init_state(seed=0)``; their leaves (``unified_q`` and
``unified_scale`` included) load into the port's trainer with
``params_from_jax``. Both then take 5 steps on the same numpy batches of 64
rows, whose ids repeat. DeepFM's and FM's batches come from seed 2, as in
``tests/test_torch_deepfm_training.py`` (under seed 0 one id's summed
gradient cancels to near Adam's eps).

Tolerances, as ``tests/test_torch_dcnv2_int8_training.py``: each step's loss
rtol 1e-5; after 5 steps the touched rows' scale rtol 1e-4 / atol 1e-6 and
their q values off by at most one in at most 0.1% of them (at least one);
the accumulators (``table_acc``) rtol 1e-4; untouched rows bit-identical;
dense parameters rtol 1e-4 / atol 1e-6; scores after training rtol 1e-4 /
atol 1e-6. f32 sums run in another order in the two frameworks (the dense
layers' products, the duplicate ids' grads), and a q value moves by one
where that puts ``row / scale + u`` on the other side of an integer.

On unique ids the classic step and the packed step (``packed_tables=True``)
agree bit for bit from the same table, in the port as in JAX
(``tests/test_quantized.py``'s own check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu import models as jmodels
from pytorchrec_tpu.ops.kernels import quantize as jq
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch import models as tmodels
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.ops.kernels.fm import fm_interaction, fm_interaction_backward
from pytorchrec_tpu_torch.ops.kernels.quantize import (
    dequantize_rows,
    quantize_rows,
    requantize_rows,
    stochastic_quantize_rows,
    table_rounding_salt,
    unpack_int4,
)
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.ops.quantized_packed import pack_quantized_table
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH, STEPS, LR, E = 50, 3, 2, 64, 5, 1e-2, 4
EXTRA = {"DCNv2": {"num_cross_layers": 2, "layers": (8,)}, "DeepFM": {"layers": (8,)},
         "FM": {}}
SEEDS = {"DCNv2": 0, "DeepFM": 2, "FM": 2}
FORMATS = [(8, 1), (4, 1), (8, 2)]
KERNELS = (cross_network, fm_interaction, fm_interaction_backward, segmented_sum_scan,
           stochastic_quantize_rows, requantize_rows, scatter_set_rows)
Q, S = "unified_q", "unified_scale"


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


def _columns(fc, vocab=VOCAB, n_sparse=N_SPARSE, n_dense=N_DENSE):
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=vocab)
                             for i in range(n_sparse)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(n_dense)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


def _quant(bits=8, groups=1, packed=False):
    return dict(unified_embedding=True, quantized_embedding=True, table_packed=packed,
                table_bits=bits, scale_col_groups=groups)


def _jax_model(name, bits=8, groups=1, packed=False, **columns):
    return getattr(jmodels, name)(**_columns(jfc, **columns), emb_size=E, **EXTRA[name],
                                  **_quant(bits, groups, packed))


def _port_model(name, bits=8, groups=1, packed=False, **columns):
    return getattr(tmodels, name)(**_columns(tfc, **columns), emb_size=E, device="cpu",
                                  generator=torch.Generator().manual_seed(0), **EXTRA[name],
                                  **_quant(bits, groups, packed))


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _pair(name, bits, groups, batches, lr=LR):
    jax_trainer = QuantizedEmbeddingTrainer(_jax_model(name, bits, groups))
    jax_trainer.compile(optimizer="adam", lr=lr, loss="bce", metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    port = TorchQuantizedTrainer(_port_model(name, bits, groups), device="cpu")
    port.compile(optimizer="adam", lr=lr, loss="bce", metrics=())
    port.init_state(batches[0], seed=0)
    params_from_jax(_flat(jax_trainer.state.params), port)
    return jax_trainer, port


def _touched(batches):
    touched = np.zeros(N_SPARSE * VOCAB, bool)
    for batch in batches:
        for i in range(N_SPARSE):
            touched[batch[f"c_{i}"] + i * VOCAB] = True
    return touched


def _q_values(q, bits):
    q = np.asarray(q)
    return np.asarray(unpack_int4(torch.from_numpy(q))) if bits == 4 else q


@pytest.mark.parametrize("bits,groups", FORMATS)
@pytest.mark.parametrize("name", ["DCNv2", "DeepFM", "FM"])
def test_five_classic_train_steps_match_jax(name, bits, groups):
    batches = _batches(seed=SEEDS[name])
    jax_trainer, port = _pair(name, bits, groups, batches)
    assert port.state.packed == {} and list(port.state.table_acc) == ["unified"]
    acc = port.state.table_acc["unified"]
    assert acc.shape == (N_SPARSE * VOCAB,) and not acc.any()
    q, scale = port.model.unified_q, port.model.unified_scale
    start_q, start_s = q.clone(), scale.clone()
    before = [k.launches for k in KERNELS]
    for step, batch in enumerate(batches):
        want_salt = int(jq.table_rounding_salt(jax_trainer.state.rng,
                                               jax_trainer.state.step + 1, Q))
        assert table_rounding_salt(port.state.rng_key, step + 1, Q) == want_salt
        want = float(jax_trainer._train_step(batch))
        got = port.train_step(batch)
        assert got.shape == () and port.state.step == step + 1
        np.testing.assert_allclose(float(got), want, rtol=1e-5, err_msg=f"step {step}")
    assert [k.launches for k in KERNELS] == before  # the CPU runs the plain versions
    # updated in place: the model's own buffers and the state's accumulator
    assert port.model.unified_q is q and port.model.unified_scale is scale
    assert port.state.table_acc["unified"] is acc

    flat = _flat(jax_trainer.state.params)
    touched = _touched(batches)
    untouched = torch.from_numpy(~touched)
    assert torch.equal(q[untouched], start_q[untouched])
    assert torch.equal(scale[untouched], start_s[untouched])
    assert not acc[untouched].any() and bool((acc[torch.from_numpy(touched)] > 0).all())
    got_q, want_q = _q_values(q.numpy(), bits)[touched], _q_values(flat[Q], bits)[touched]
    diff = np.abs(got_q.astype(np.int32) - want_q.astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000), diff.sum()
    np.testing.assert_allclose(scale.numpy()[touched], flat[S][touched], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jax_trainer.state.table_acc["unified"]),
                               rtol=1e-4)

    dense = params_from_jax(flat, _port_model(name, bits, groups)).state_dict()
    for key, value in port.model.state_dict().items():
        if key not in (Q, S):
            np.testing.assert_allclose(value.numpy(), dense[key].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=key)

    serve_batch = {k: v for k, v in _batches(1, seed=7)[0].items() if k != "label"}
    want = np.asarray(jax_trainer.make_serving_fn()(serve_batch))
    got = port.make_serving_fn()(serve_batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_duplicate_ids_do_not_clobber_the_last_row():
    """The JAX package's regression (``tests/test_quantized.py``): the
    padding slots of the dedup alias the last unique id, so a scatter-set
    that let them through would revert that id's update. The max unified id
    repeats; with lr 1 every touched row must move by more than 0.05, and
    the untouched ones not at all; the rows match JAX's after the step."""
    model_kwargs = dict(vocab=4, n_sparse=2, n_dense=0)
    batch = {"c_0": np.array([3, 3, 1, 1, 0, 0], np.int32),
             "c_1": np.array([3, 3, 2, 2, 0, 0], np.int32),
             "label": np.array([1, 0, 1, 0, 1, 0], np.int32)}
    jax_trainer = QuantizedEmbeddingTrainer(_jax_model("FM", **model_kwargs))
    jax_trainer.compile(optimizer="adam", lr=1.0, loss="bce", metrics=())
    jax_trainer.init_state(batch, seed=0)
    port = TorchQuantizedTrainer(_port_model("FM", **model_kwargs), device="cpu")
    port.compile(optimizer="adam", lr=1.0, loss="bce")
    port.init_state(batch, seed=0)
    params_from_jax(_flat(jax_trainer.state.params), port)

    def rows():
        return dequantize_rows(port.model.unified_q, port.model.unified_scale).numpy()

    before = rows()
    jax_trainer._train_step(batch)
    port.train_step(batch)
    after = rows()
    for i in (0, 1, 3, 4, 6, 7):
        assert np.abs(after[i] - before[i]).max() > 0.05, i
    np.testing.assert_array_equal(after[[2, 5]], before[[2, 5]])
    flat = _flat(jax_trainer.state.params)
    np.testing.assert_allclose(after, np.asarray(jq.dequantize_rows(flat[Q], flat[S])),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bits,groups", FORMATS)
def test_classic_and_packed_steps_agree_on_unique_ids(bits, groups):
    """One step from the same table on ids unique within each field: the
    classic step and the packed step give the same q and scale bit for bit
    and accumulators within rtol 1e-6 (the JAX package's own check, here for
    the port's two layouts)."""
    rng = np.random.default_rng(5)
    vocab, rows = 300, 32
    model_kwargs = dict(vocab=vocab, n_dense=1)
    batch = {f"c_{i}": rng.permutation(vocab)[:rows].astype(np.int32) for i in range(N_SPARSE)}
    batch["d_0"] = rng.normal(size=rows).astype(np.float32)
    batch["label"] = rng.integers(0, 2, size=rows).astype(np.int32)

    classic = TorchQuantizedTrainer(_port_model("DCNv2", bits, groups, **model_kwargs),
                                    device="cpu")
    classic.compile(optimizer="adam", lr=0.05, loss="bce")
    classic.init_state(batch, seed=3)
    q0, s0 = classic.model.unified_q.clone(), classic.model.unified_scale.clone()
    packed = TorchQuantizedTrainer(_port_model("DCNv2", bits, groups, packed=True,
                                               **model_kwargs),
                                   device="cpu", packed_tables=True)
    packed.compile(optimizer="adam", lr=0.05, loss="bce")
    packed.init_state(batch, seed=3)
    packed.model.load_state_dict(
        {k: v for k, v in classic.model.state_dict().items() if k not in (Q, S)}, strict=False)
    packed.state.packed[Q].copy_(pack_quantized_table(q0, s0, torch.zeros(q0.shape[0]), E,
                                                      bits, groups))
    packed.train_step(batch)
    classic.train_step(batch)
    want_q, want_s, want_acc = packed.unpacked_quantized()["unified"]
    assert torch.equal(classic.model.unified_q, want_q)
    assert torch.equal(classic.model.unified_scale, want_s)
    torch.testing.assert_close(classic.state.table_acc["unified"], want_acc, rtol=1e-6,
                               atol=1e-8)
    assert int((want_acc > 0).sum()) == N_SPARSE * rows


def test_init_state_draws_q_and_scale_apart_from_the_seed():
    """The JAX init's quirk: after the dense parameters, q comes from one
    N(0, 0.01) draw and the scale from a second one, each rounded to
    nearest; replayed here from the seed's generator."""
    def init(seed):
        trainer = TorchQuantizedTrainer(_port_model("DCNv2"), device="cpu")
        trainer.compile(optimizer="adam", lr=LR, loss="bce")
        trainer.init_state(_batches(1)[0], seed=seed)
        return trainer

    a, b, c = init(0), init(0), init(1)
    q, scale = a.model.unified_q, a.model.unified_scale
    assert torch.equal(q, b.model.unified_q) and torch.equal(scale, b.model.unified_scale)
    assert not torch.equal(q, c.model.unified_q) and not torch.equal(scale, c.model.unified_scale)
    assert not a.state.table_acc["unified"].any()
    gen = torch.Generator().manual_seed(0)
    for param in a.model.parameters():
        torch.empty_like(param).normal_(0.0, 0.01, generator=gen)
    first, second = (torch.empty((N_SPARSE * VOCAB, E)).normal_(0.0, 0.01, generator=gen)
                     for _ in range(2))
    assert torch.equal(q, quantize_rows(first)[0])
    assert torch.equal(scale, quantize_rows(second)[1])
    assert not torch.equal(scale, quantize_rows(first)[1])



def test_fit_steps_logs_the_loss_each_window():
    batches = _batches(7)
    jax_trainer, port = _pair("DCNv2", 8, 1, batches)
    want = jax_trainer.fit_steps(iter(batches), steps=7, log_every=3, verbose=0)
    got = port.fit_steps(iter(batches), steps=7, log_every=3)
    assert got.epoch == [0, 1, 2] and port.state.step == 7
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=1e-5)


def test_layouts_must_agree_and_classic_tables_are_not_unpacked():
    batch = _batches(1)[0]
    trainer = TorchQuantizedTrainer(_port_model("DCNv2", packed=True), device="cpu")
    trainer.compile(optimizer="adam", lr=LR, loss="bce")
    with pytest.raises(ValueError, match="must agree"):
        trainer.init_state(batch, seed=0)
    trainer = TorchQuantizedTrainer(_port_model("DCNv2"), device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=LR, loss="bce")
    with pytest.raises(ValueError, match="must agree"):
        trainer.init_state(batch, seed=0)
    trainer = TorchQuantizedTrainer(_port_model("DCNv2"), device="cpu")
    trainer.compile(optimizer="adam", lr=LR, loss="bce")
    trainer.init_state(batch, seed=0)
    with pytest.raises(ValueError):
        trainer.unpacked_quantized()
