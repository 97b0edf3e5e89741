"""The slice end to end on the CPU: DIN scores from the port against JAX.

A small DIN (E=8, attention (16, 8), MLP (16, 8), 50 users, 200 items,
histories of 5 with PAD ids) is initialised in JAX (``init_state(seed=0)``)
under the trainer that owns each table layout: per-table f32 under
``Trainer``, packed f32 ``u_embeddings`` and ``i_embeddings`` leaves under
``SparseEmbeddingTrainer(packed_tables=True)``, the int8 packed ``i_q`` beside
the f32 user table under ``QuantizedEmbeddingTrainer(packed_tables=True)``.
Its flax leaves go through ``params_from_jax`` and the port's
``Trainer.make_serving_fn()`` scores the same numpy batches as JAX's
``make_serving_fn()``: point-wise rows, ranking rows of 2 candidates and the
leave-one-out shape of 100.

Tolerance rtol 1e-5 / atol 1e-8: a score is the head's sum over the MLP,
whose f32 sums run in another order in the two frameworks; the weights are
N(0, 0.01), so scores are of order 1e-4 and 1e-8 is one part in 1e4 of
that.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models.din import DIN as JaxDIN
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu.training.trainer import Trainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DIN
from pytorchrec_tpu_torch.ops.kernels import din_attention as din_kernels
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

USERS, ITEMS, E, S, BATCH = 50, 200, 8, 5, 16
RTOL, ATOL = 1e-5, 1e-8
SIZES = dict(emb_size=E, att_hidden_units=(16, 8), mlp_layers=(16, 8))

# layout -> (model kwargs, JAX trainer)
LAYOUTS = {
    "f32": ({}, Trainer),
    "packed_f32": ({}, lambda m: SparseEmbeddingTrainer(m, packed_tables=True)),
    "int8_packed": ({"quantized_table": True},
                    lambda m: QuantizedEmbeddingTrainer(m, packed_tables=True)),
}


def _columns(fc):
    col = fc.CategoricalColumnWithIdentity
    return dict(uid_column=col(feature_name="uid", category_num=USERS),
                iid_column=col(feature_name="iid", category_num=ITEMS),
                his_column=col(feature_name="pos_his", category_num=ITEMS),
                his_len_column=col(feature_name="pos_his_len", category_num=S + 1),
                label_column=col(feature_name="label", category_num=2))


def _batch(rng, rows, candidates=None):
    """A batch as the history reader lays it out: histories of ``len`` ids,
    then PAD (0)."""
    lengths = rng.integers(0, S + 1, size=rows).astype(np.int32)
    his = rng.integers(1, ITEMS, size=(rows, S)).astype(np.int32)
    his[np.arange(S)[None, :] >= lengths[:, None]] = 0
    shape = rows if candidates is None else (rows, candidates)
    return {"uid": rng.integers(0, USERS, size=rows).astype(np.int32),
            "iid": rng.integers(0, ITEMS, size=shape).astype(np.int32),
            "pos_his": his, "pos_his_len": lengths,
            "label": rng.integers(0, 2, size=rows).astype(np.int32)}


def _batches():
    rng = np.random.default_rng(0)
    return {"pointwise": _batch(rng, BATCH), "ranking": _batch(rng, BATCH, 2),
            "leave_one_out": _batch(rng, 4, 100)}


def _jax_trainer(layout, sample):
    kwargs, make_trainer = LAYOUTS[layout]
    trainer = make_trainer(JaxDIN(**_columns(jfc), **SIZES, **kwargs))
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=())
    trainer.init_state(sample, seed=0)
    return trainer


def _port_model(layout):
    kwargs, _ = LAYOUTS[layout]
    return DIN(**_columns(tfc), **SIZES, **kwargs, device="cpu",
               generator=torch.Generator().manual_seed(0))


def _flat_leaves(trainer):
    params = jax.device_get(trainer.state.params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


@pytest.mark.parametrize("mode", ["pointwise", "ranking", "leave_one_out"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_serving_matches_jax(layout, mode):
    batches = _batches()
    jax_trainer = _jax_trainer(layout, batches["pointwise"])
    batch = {k: v for k, v in batches[mode].items() if k != "label"}  # serving needs no label
    want = np.asarray(jax_trainer.make_serving_fn()(batch))

    model = params_from_jax(_flat_leaves(jax_trainer), _port_model(layout))
    before = din_kernels.din_attention_pool.launches
    got = TorchTrainer(model, device="cpu").make_serving_fn()(batch)
    assert din_kernels.din_attention_pool.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_leaves_load_into_the_model_and_unknown_leaves_raise():
    batches = _batches()
    for layout in LAYOUTS:
        flat = _flat_leaves(_jax_trainer(layout, batches["pointwise"]))
        model = params_from_jax(flat, _port_model(layout))
        names = set(model.state_dict())
        assert {"attention.w0", "attention.b2", "mlp.layers.1.linear.weight",
                "head.weight"} <= names and "head.bias" not in names
        torch.testing.assert_close(model.attention.w0, torch.from_numpy(flat["attention/w0"]))
        if layout == "int8_packed":
            assert torch.equal(model.i_q, torch.from_numpy(flat["i_q"]))
            assert "i_embeddings.embedding" not in names
        else:
            width = flat["i_embeddings/embedding"].shape[1]
            assert width == (E if layout == "f32" else 64)  # packed: table || m || v || pad
            torch.testing.assert_close(model.i_embeddings.embedding,
                                       torch.from_numpy(flat["i_embeddings/embedding"][:, :E]))
        with pytest.raises(KeyError):
            params_from_jax({**flat, "attention/w9": flat["attention/w0"]}, _port_model(layout))
        with pytest.raises(KeyError):
            params_from_jax({**flat, "mystery/kernel": flat["head/kernel"]}, _port_model(layout))


def test_tables_and_injected_rows():
    """The protocols name both tables with their keys; injected rows,
    candidates first, give the scores of the model's own gathers, and the
    swapped order does not."""
    batch = {k: torch.as_tensor(v) for k, v in _batches()["ranking"].items()}
    model = _port_model("f32")
    specs = model.sharded_table_specs(batch)
    assert [s["path"] for s in specs.values()] == ["u_embeddings/embedding",
                                                  "i_embeddings/embedding"]
    assert [s["rows_key"] for s in specs.values()] == [DIN.U_ROWS_KEY, DIN.I_ROWS_KEY]
    ids = specs["i"]["ids"]
    assert ids.shape == (BATCH * 2 + BATCH * S,)
    assert torch.equal(ids[:BATCH * 2], batch["iid"].reshape(-1).long())
    assert set(model.sparse_table_ids(batch)) == {"u_embeddings/embedding",
                                                  "i_embeddings/embedding"}
    with torch.no_grad():
        want, target = model(batch)
        assert target.tolist() == [[1.0, 0.0]] * BATCH  # one-hot-first
        rows = model.i_embeddings.embedding[ids]
        injected = {**batch, DIN.U_ROWS_KEY: model.u_embeddings.embedding[batch["uid"].long()],
                    DIN.I_ROWS_KEY: rows}
        got, _ = model(injected)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        swapped = torch.cat([rows[BATCH * 2:], rows[:BATCH * 2]])
        assert not torch.equal(model({**injected, DIN.I_ROWS_KEY: swapped})[0], want)
    with pytest.raises(ValueError):
        model.quantized_table_spec(batch)
    quantized = _port_model("int8_packed")
    assert quantized.sharded_table_specs(batch)["i"]["path"] == "i_q"
    assert [s["q"] for s in quantized.quantized_table_spec(batch).values()] == ["i_q"]


def test_quantized_din_trains_only_under_the_quantized_trainer():
    sample = _batches()["pointwise"]
    trainer = TorchSparseTrainer(_port_model("int8_packed"), device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce")
    with pytest.raises(ValueError):
        trainer.init_state(sample, seed=0)
    trainer = TorchQuantizedTrainer(_port_model("f32"), device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce")
    with pytest.raises(ValueError):
        trainer.init_state(sample, seed=0)
