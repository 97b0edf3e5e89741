"""The packed table formats on the CPU: widths, byte rows, bf16 rows and
``packed_min_width``, the port against JAX.

* ``packed_width`` and ``packed_bytes_width`` equal JAX's over E x table
  optimizer x ``min_width``, and refuse a ``min_width`` that is not a
  multiple of 64, as JAX asserts;
* the packed updates over f32, byte and bf16 rows on ids with a run of 40
  duplicates: every stored bit equals JAX's (both scan the duplicates in the
  same Hillis-Steele order and sum rowwise Adagrad's squares in column
  order), and the byte update's fields equal the f32 update's bit for bit;
* the bf16 update is bit-predictable, as JAX's ``tests/test_sparse_update.py::
  test_packed_bf16_update_bit_predictable`` asserts: the f32 update over
  bf16-rounded inputs, rounded to bf16, gives the bf16 update's bits;
* the trainer (DCN-v2, a unified table of 3 fields of vocab 50, E=4, 2 dense
  fields) with ``packed_bytes``, ``packed_dtype="bfloat16"`` and
  ``packed_min_width=128``, 5 steps from JAX's ``init_state(seed=0)`` on
  Zipf-skewed batches: byte rows bit-identical to the port's f32 packed rows
  and serving; against JAX each loss rtol 1e-5, f32 and byte tables and the
  dense parameters rtol 1e-4 / atol 1e-6 (as
  ``tests/test_torch_dcnv2_training.py``), bf16 table values within one
  bf16 ulp (a last-bit difference in the f32 arithmetic may round a value
  the other way) and bf16 moments within two (a moment carries its rounding
  from step to step, so a one-ulp difference may gain another at a later
  step's rounding);
* serving gives f32 scores from bf16 and byte rows; ``unpacked_params`` f32
  tables; ``params_from_jax`` takes JAX's u8 and bf16 packed leaves, into the
  trainer whole and into a plain model as its f32 table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models import DCNv2
from pytorchrec_tpu.ops import sparse_update as jsu
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch import models as tmodels
from pytorchrec_tpu_torch.ops import sparse_update as tsu
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import leaves_of

VOCAB, N_SPARSE, N_DENSE, BATCH, STEPS, LR, E = 50, 3, 2, 64, 5, 1e-2, 4
OPTIMIZERS = ("adam", "adagrad", "rowwise_adagrad")
TABLE = "unified_emb/embedding"
ARCH = dict(emb_size=E, num_cross_layers=2, layers=(8,), unified_embedding=True)
FORMATS = {"bytes": dict(packed_bytes=True), "bf16": dict(packed_dtype="bfloat16"),
           "f32w128": dict(packed_min_width=128)}


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_widths_match_jax(optimizer):
    for e in (1, 4, 16, 17, 64):
        for min_width in (64, 128, 192, 256):
            assert tsu.packed_width(e, optimizer, min_width) == \
                jsu.packed_width(e, optimizer, min_width)
            assert tsu.packed_bytes_width(e, optimizer, min_width) == \
                jsu.packed_bytes_width(e, optimizer, min_width)
        assert tsu.packed_width(e, optimizer) == jsu.packed_width(e, optimizer)
    assert tsu.packed_bytes_width(16, "rowwise_adagrad") == 192  # 132 bytes of fields
    for width in (tsu.packed_width, tsu.packed_bytes_width):
        with pytest.raises(ValueError):
            width(16, optimizer, 96)
    with pytest.raises(AssertionError):
        jsu.packed_width(16, optimizer, 96)
    trainer = TorchSparseTrainer(_port_model(), device="cpu", packed_tables=True,
                                 packed_min_width=96)
    trainer.compile()
    with pytest.raises(ValueError):
        trainer.init_state(_batches(1)[0], seed=0)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_packed_tables_match_jax(optimizer):
    table = np.random.default_rng(0).normal(size=(30, 5)).astype(np.float32)
    got = tsu.pack_table(torch.from_numpy(table), optimizer, 128, torch.bfloat16)
    want = jsu.pack_table(jnp.asarray(table), optimizer, 128, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    got = tsu.pack_table_bytes(torch.from_numpy(table), optimizer, 128)
    want = np.asarray(jsu.pack_table_bytes(jnp.asarray(table), optimizer, 128))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    unpacked = tsu.unpack_table_bytes(got, 5)
    assert unpacked.dtype == torch.float32 and unpacked.data_ptr() == got.data_ptr()  # a view
    np.testing.assert_array_equal(unpacked.numpy(), table)


def _update_case(optimizer, layout, seed=11):
    """One packed update of each package on the same rows: (JAX's new table,
    the port's), both as numpy."""
    rng = np.random.default_rng(seed)
    v = 300
    c = tsu.PACKED_COLS[optimizer](16)
    table = rng.normal(size=(v, 16)).astype(np.float32)
    moments = (np.abs(rng.normal(size=(v, c - 16))) * 0.1).astype(np.float32)
    ids = rng.permutation(np.concatenate([np.full(40, 7), rng.integers(0, v, 88)]))
    ids = ids.astype(np.int32)
    dvec = rng.normal(size=(ids.size, 16)).astype(np.float32)
    if layout == "bytes":
        packed = np.array(jsu.pack_table_bytes(jnp.asarray(table), optimizer))
        packed.view(np.float32)[:, 16:c] = moments
        j_update, t_update = jsu.packed_sparse_update_bytes, tsu.packed_sparse_update_bytes
        j_packed, t_packed = jnp.asarray(packed), torch.from_numpy(packed)
    else:
        dtype = jnp.bfloat16 if layout == "bf16" else jnp.float32
        j_packed = jsu.pack_table(jnp.asarray(table), optimizer, dtype=dtype)
        j_packed = j_packed.at[:, 16:c].set(jnp.asarray(moments).astype(dtype))
        t_packed = tsu.pack_table(torch.from_numpy(table), optimizer,
                                  dtype=torch.bfloat16 if layout == "bf16" else None)
        t_packed[:, 16:c] = torch.from_numpy(moments)
        j_update, t_update = jsu.packed_sparse_update, tsu.packed_sparse_update
    want = j_update(j_packed, j_packed[ids], jnp.asarray(ids), jnp.asarray(dvec), jnp.asarray(4),
                    lr=LR, optimizer=optimizer)
    t_ids = torch.from_numpy(ids)
    got = t_update(t_packed, t_packed[t_ids.long()], t_ids, torch.from_numpy(dvec), 4, LR,
                   optimizer)
    if layout == "bf16":
        return np.asarray(want.astype(jnp.float32)), got.float().numpy()
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("layout", ["f32", "bytes", "bf16"])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_packed_updates_bit_exact_against_jax(optimizer, layout):
    want, got = _update_case(optimizer, layout)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_byte_update_bit_identical_to_f32_update(optimizer):
    c = tsu.PACKED_COLS[optimizer](16)
    _, f32 = _update_case(optimizer, "f32")
    _, as_bytes = _update_case(optimizer, "bytes")
    assert as_bytes.dtype == np.uint8 and as_bytes.shape[1] == tsu.packed_bytes_width(16, optimizer)
    np.testing.assert_array_equal(as_bytes.view(np.float32)[:, :c], f32[:, :c])
    assert not as_bytes.view(np.float32)[:, c:].any() and not f32[:, c:].any()  # staging zero


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_bf16_update_bit_predictable(optimizer):
    rng = np.random.default_rng(11)
    v, e = 300, 16
    table = torch.from_numpy(rng.normal(size=(v, e)).astype(np.float32))
    c = tsu.PACKED_COLS[optimizer](e)
    state = torch.from_numpy((np.abs(rng.normal(size=(v, c - e))) * 0.1).astype(np.float32))
    for ids in (np.concatenate([np.full(40, 7), rng.integers(0, v, size=88)]),
                rng.integers(0, v, size=64)):
        ids = torch.from_numpy(ids.astype(np.int32))
        dvec = torch.from_numpy(rng.normal(size=(ids.shape[0], e)).astype(np.float32))
        pk16 = tsu.pack_table(table, optimizer, dtype=torch.bfloat16)
        pk16[:, e:c] = state.bfloat16()
        out16 = tsu.packed_sparse_update(pk16, pk16[ids.long()], ids, dvec, 4, 0.01, optimizer)
        assert out16.dtype == torch.bfloat16
        pk = tsu.pack_table(table.bfloat16().float(), optimizer)
        pk[:, e:c] = state.bfloat16().float()
        out = tsu.packed_sparse_update(pk, pk[ids.long()], ids, dvec.bfloat16().float(), 4, 0.01,
                                       optimizer)
        assert torch.equal(out16[:, :c].float(), out[:, :c].bfloat16().float())


# ------------------------------------------------------------------ trainer


def _columns(fc):
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


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


def _port_model():
    return tmodels.DCNv2(**_columns(tfc), **ARCH, device="cpu",
                         generator=torch.Generator().manual_seed(0))


def _flat(tree):
    tree = jax.device_get(tree)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_trainer(table_optimizer="adam", **kwargs):
    trainer = SparseEmbeddingTrainer(DCNv2(**_columns(jfc), **ARCH),
                                     table_optimizer=table_optimizer, packed_tables=True,
                                     **kwargs)
    trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    trainer.init_state(_batches(1)[0], seed=0)
    return trainer


def _port_trainer(flat, table_optimizer="adam", **kwargs):
    port = TorchSparseTrainer(_port_model(), device="cpu", table_optimizer=table_optimizer,
                              packed_tables=True, **kwargs)
    port.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    port.init_state(_batches(1)[0], seed=0)
    return params_from_jax(flat, port)


def _serve_batch():
    return {k: v for k, v in _batches(1, seed=7)[0].items() if k != "label"}


@pytest.mark.parametrize("table_optimizer", ["adam", "rowwise_adagrad"])
def test_byte_trainer_bit_identical_to_f32_trainer(table_optimizer):
    """As JAX's ``test_packed_bytes_trainer_bit_identical``: the byte rows
    are a bit view of the same fields, so every loss, table value, dense
    parameter and score equals the f32 layout's."""
    f32 = _port_trainer(_flat(_jax_trainer(table_optimizer).state.params), table_optimizer)
    as_bytes = _port_trainer(_flat(_jax_trainer(table_optimizer, packed_bytes=True).state.params),
                             table_optimizer, packed_bytes=True)
    table = as_bytes.state.packed[TABLE]
    assert table.dtype == torch.uint8 and table.shape[1] == tsu.packed_bytes_width(
        E, table_optimizer)
    c = tsu.PACKED_COLS[table_optimizer](E)
    assert torch.equal(table.view(torch.float32)[:, :c], f32.state.packed[TABLE][:, :c])
    for batch in _batches():
        assert torch.equal(as_bytes.train_step(batch), f32.train_step(batch))
    assert torch.equal(table.view(torch.float32)[:, :c], f32.state.packed[TABLE][:, :c])
    want = f32.model.state_dict()
    for key, value in as_bytes.unpacked_params().items():
        assert value.dtype == torch.float32 and torch.equal(value, want[key]), key
    assert torch.equal(as_bytes.make_serving_fn()(_serve_batch()),
                       f32.make_serving_fn()(_serve_batch()))


@pytest.mark.parametrize("name", list(FORMATS))
def test_five_steps_of_each_format_match_jax(name):
    kwargs = FORMATS[name]
    jax_trainer = _jax_trainer(**kwargs)
    flat = _flat(jax_trainer.state.params)
    port = _port_trainer(flat, **kwargs)
    buffer = port.state.packed[TABLE]
    assert buffer.dtype == {"bytes": torch.uint8, "bf16": torch.bfloat16,
                            "f32w128": torch.float32}[name]
    assert tuple(buffer.shape) == flat[TABLE].shape
    if name == "f32w128":
        assert buffer.shape[1] == 128
    address = buffer.data_ptr()
    for step, batch in enumerate(_batches()):
        want = float(jax_trainer._train_step(batch))
        np.testing.assert_allclose(float(port.train_step(batch)), want, rtol=1e-5,
                                   err_msg=f"step {step}")
    assert port.state.packed[TABLE].data_ptr() == address
    flat = _flat(jax_trainer.state.params)
    got = leaves_of(port)
    for path, want in flat.items():
        if path == TABLE and name == "bf16":
            g, w = got[path].float().numpy(), want.astype(np.float32)
            ulp = np.spacing(np.abs(w).astype(np.float32)) * 2 ** 16  # bf16 keeps 8 of f32's 24
            ulps = np.abs(g - w) / ulp
            assert (ulps[:, :E] <= 1).all() and (ulps[:, E:] <= 2).all(), path
        elif path == TABLE and name == "bytes":
            np.testing.assert_allclose(got[path].view(torch.float32).numpy(),
                                       want.view(np.float32), rtol=1e-4, atol=1e-6)
        elif path in {k.replace(".", "/") for k in port.model.state_dict()} or path == TABLE:
            np.testing.assert_allclose(got[path].numpy(), want, rtol=1e-4, atol=1e-6,
                                       err_msg=path)
    scores = port.make_serving_fn()(_serve_batch())
    assert scores.dtype == torch.float32
    np.testing.assert_allclose(scores.numpy(), np.asarray(jax_trainer.make_serving_fn()(
        _serve_batch())), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["bytes", "bf16"])
def test_jax_packed_leaves_load_into_trainer_and_model(name):
    jax_trainer = _jax_trainer(**FORMATS[name])
    for batch in _batches(2):
        jax_trainer._train_step(batch)
    flat = _flat(jax_trainer.state.params)
    assert flat[TABLE].dtype.name == {"bytes": "uint8", "bf16": "bfloat16"}[name]
    port = TorchSparseTrainer(_port_model(), device="cpu", packed_tables=True, **FORMATS[name])
    port.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    port.init_state(_batches(1)[0], seed=1)
    params_from_jax(flat, port)  # the trained leaves, moments and all
    loaded = port.state.packed[TABLE]
    bits = loaded.numpy() if name == "bytes" else loaded.view(torch.int16).numpy()
    np.testing.assert_array_equal(bits, flat[TABLE] if name == "bytes"
                                  else flat[TABLE].view(np.int16))
    want = np.asarray(jax_trainer.make_serving_fn()(_serve_batch()))
    np.testing.assert_allclose(port.make_serving_fn()(_serve_batch()).numpy(), want,
                               rtol=1e-5, atol=1e-7)
    table = port.unpacked_params()["unified_emb.embedding"]
    assert table.dtype == torch.float32 and tuple(table.shape) == (N_SPARSE * VOCAB, E)
    # a plain model takes the packed leaf's table columns as f32
    model = params_from_jax(flat, _port_model())
    assert torch.equal(model.unified_emb.embedding, table)
    np.testing.assert_allclose(TorchTrainer(model, device="cpu").make_serving_fn()(
        _serve_batch()).numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["bytes", "bf16"])
def test_narrow_rows_keep_no_model_table_and_reinitialise(name, tmp_path):
    port = _port_trainer(_flat(_jax_trainer(**FORMATS[name]).state.params), **FORMATS[name])
    assert tuple(port.model.unified_emb.embedding.shape) == (0, E)  # nothing stale to read
    port.train_step(_batches(1)[0])
    path = str(tmp_path / "ckpt.pt")
    port.save_checkpoint(path)
    saved = port.state.packed[TABLE].clone()
    port.train_step(_batches(2)[1])
    address = port.state.packed[TABLE].data_ptr()
    port.restore_checkpoint(path)
    assert port.state.packed[TABLE].data_ptr() == address
    assert torch.equal(port.state.packed[TABLE], saved)
    first = port.state.packed[TABLE].clone()
    port.init_state(_batches(1)[0], seed=0)  # the table is drawn again, at its full shape
    assert port.state.packed[TABLE].shape == first.shape
    fresh = TorchSparseTrainer(_port_model(), device="cpu", packed_tables=True, **FORMATS[name])
    fresh.compile(optimizer="adam", lr=LR, loss="bce")
    fresh.init_state(_batches(1)[0], seed=0)
    assert torch.equal(port.state.packed[TABLE], fresh.state.packed[TABLE])
