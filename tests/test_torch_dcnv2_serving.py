"""The slice end to end on the CPU: DCN-v2 scores from the port against JAX.

A small DCN-v2 (3 sparse fields of vocab 50, E=4, 2 dense fields, 2 cross
layers, MLP (8,)) is initialised in JAX (``init_state(seed=0)``) under the
trainer that owns each table layout; its flax leaves are converted with
``params_from_jax`` and the port's ``Trainer.make_serving_fn()`` scores the
same numpy batches as JAX's ``make_serving_fn()``. Tolerance rtol 1e-5
(atol 1e-8 for scores that pass near zero): f32 matmuls sum in another order.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu.models import DCNv2, DeepFM
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu.training.trainer import Trainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2 as TorchDCNv2
from pytorchrec_tpu_torch.models import DeepFM as TorchDeepFM
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH = 50, 3, 2, 16
RTOL, ATOL = 1e-5, 1e-8

# layout -> (model kwargs, JAX trainer)
LAYOUTS = {
    "per_field": ({}, Trainer),
    "unified_f32": ({"unified_embedding": True}, Trainer),
    "packed_f32": ({"unified_embedding": True},
                   lambda m: SparseEmbeddingTrainer(m, packed_tables=True)),
    "int8_packed": ({"unified_embedding": True, "quantized_embedding": True,
                     "table_packed": True},
                    lambda m: QuantizedEmbeddingTrainer(m, packed_tables=True)),
    "int4_packed_2_groups": ({"unified_embedding": True, "quantized_embedding": True,
                              "table_packed": True, "table_bits": 4, "scale_col_groups": 2},
                             lambda m: QuantizedEmbeddingTrainer(m, packed_tables=True)),
}
COMMON = dict(emb_size=4, num_cross_layers=2, layers=(8,))


def _batches():
    rng = np.random.default_rng(0)
    point = {f"c_{i}": rng.integers(0, VOCAB, BATCH).astype(np.int32) for i in range(N_SPARSE)}
    point.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32) for i in range(N_DENSE)})
    point["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
    # candidate rows: c_0 and d_1 per candidate [B, N], the rest per row [B]
    cand = {f"c_{i}": rng.integers(0, VOCAB, (4, 7) if i == 0 else 4).astype(np.int32)
            for i in range(N_SPARSE)}
    cand.update({"d_0": rng.normal(size=4).astype(np.float32),
                 "d_1": rng.normal(size=(4, 7)).astype(np.float32)})
    return point, cand


def _jax_trainer(layout, sample):
    kwargs, make_trainer = LAYOUTS[layout]
    model = DCNv2(
        sparse_columns=tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                           category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        **COMMON, **kwargs)
    trainer = make_trainer(model)
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=("auc",))
    trainer.init_state(sample, seed=0)
    return trainer


def _port_model(layout):
    kwargs, _ = LAYOUTS[layout]
    return TorchDCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        device="cpu", generator=torch.Generator().manual_seed(0), **COMMON, **kwargs)


def _flat_leaves(trainer):
    params = jax.device_get(trainer.state.params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


@pytest.mark.parametrize("mode", ["pointwise", "candidates"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_serving_matches_jax(layout, mode):
    point, cand = _batches()
    jax_trainer = _jax_trainer(layout, point)
    batch = point if mode == "pointwise" else cand
    if mode == "pointwise":
        batch = {k: v for k, v in batch.items() if k != "label"}  # serving needs no label
    want = np.asarray(jax_trainer.make_serving_fn()(batch))

    model = params_from_jax(_flat_leaves(jax_trainer), _port_model(layout))
    before = cross_network.launches
    got = TorchTrainer(model, device="cpu").make_serving_fn()(batch)
    assert cross_network.launches == before  # CPU: the plain version, no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_forward_returns_label_and_candidate_targets():
    point, cand = _batches()
    model = _port_model("unified_f32")
    with torch.no_grad():
        _, target = model(point)
        _, cand_target = model(cand)
        _, no_label = model({k: v for k, v in point.items() if k != "label"})
    np.testing.assert_array_equal(target.numpy(), point["label"].astype(np.float32))
    assert cand_target.shape == (4, 7) and cand_target[:, 0].eq(1).all()
    assert cand_target[:, 1:].eq(0).all() and no_label is None


def test_converter_slices_packed_f32_and_drops_unread_leaves():
    point, _ = _batches()
    flat = _flat_leaves(_jax_trainer("packed_f32", point))
    assert flat["unified_emb/embedding"].shape[1] == 64  # table || m || v || pad
    assert {"bias", "dense_factors", "dense_linear"} <= set(flat)
    model = params_from_jax(flat, _port_model("packed_f32"))
    np.testing.assert_array_equal(model.unified_emb.embedding.detach().numpy(),
                                  flat["unified_emb/embedding"][:, :4])
    np.testing.assert_array_equal(model.deep.layers[0].linear.weight.detach().numpy(),
                                  flat["deep/Dense_0/Dense_0/kernel"].T)


def test_converter_passes_int8_rows_through():
    point, _ = _batches()
    flat = _flat_leaves(_jax_trainer("int8_packed", point))
    model = params_from_jax(flat, _port_model("int8_packed"))
    assert model.unified_q.dtype == torch.uint8
    np.testing.assert_array_equal(model.unified_q.numpy(), flat["unified_q"])


@pytest.mark.parametrize("change", ["unknown_leaf", "unmatched_path", "missing_leaf",
                                    "wrong_shape"])
def test_converter_raises_on_leaves_it_cannot_place(change):
    point, _ = _batches()
    flat = _flat_leaves(_jax_trainer("unified_f32", point))
    if change == "unknown_leaf":
        flat["lin_c_0/embedding"] = np.zeros((VOCAB, 1), np.float32)
    elif change == "unmatched_path":
        flat["unified_scale"] = np.ones((N_SPARSE * VOCAB,), np.float32)
    elif change == "missing_leaf":
        del flat["cross/ws"]
    else:
        flat["head/bias"] = np.zeros((2,), np.float32)
    with pytest.raises((KeyError, ValueError)):
        params_from_jax(flat, _port_model("unified_f32"))


def _deepfm_pair(make_trainer, sample):
    """A JAX DeepFM (unified tables) under ``make_trainer`` and a port DeepFM
    of the same widths."""
    cols = dict(
        sparse_columns=tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                           category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)))
    trainer = make_trainer(DeepFM(**cols, emb_size=4, layers=(8,), unified_embedding=True))
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=())
    trainer.init_state(sample, seed=0)
    port = TorchDeepFM(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        emb_size=4, layers=(8,), unified_embedding=True, device="cpu",
        generator=torch.Generator().manual_seed(0))
    return trainer, port


@pytest.mark.parametrize("layout", ["unified_f32", "packed_f32"])
def test_converter_loads_the_linear_term_where_the_model_reads_it(layout):
    """DeepFM reads the three leaves DCN-v2 drops, and its linear table,
    plain ``[V, 1]`` or packed ``[V, 64]`` (sliced to its first column)."""
    point, _ = _batches()
    make = Trainer if layout == "unified_f32" else (
        lambda m: SparseEmbeddingTrainer(m, packed_tables=True))
    jax_trainer, port = _deepfm_pair(make, point)
    flat = _flat_leaves(jax_trainer)
    assert flat["unified_lin/embedding"].shape == (
        N_SPARSE * VOCAB, 1 if layout == "unified_f32" else 64)
    model = params_from_jax(flat, port)
    for key in ("bias", "dense_factors", "dense_linear"):
        np.testing.assert_array_equal(getattr(model, key).detach().numpy(), flat[key])
    np.testing.assert_array_equal(model.unified_lin.embedding.detach().numpy(),
                                  flat["unified_lin/embedding"][:, :1])
    np.testing.assert_array_equal(model.deep_head.weight.detach().numpy(),
                                  flat["deep_head/kernel"].T)
    del flat["dense_linear"]
    with pytest.raises(KeyError):  # a parameter the model reads needs its leaf
        params_from_jax(flat, model)


def test_converter_loads_two_packed_leaves_into_one_trainer():
    point, _ = _batches()
    jax_trainer, port_model = _deepfm_pair(
        lambda m: SparseEmbeddingTrainer(m, packed_tables=True), point)
    flat = _flat_leaves(jax_trainer)
    flat["unified_lin/embedding"] = flat["unified_lin/embedding"].copy()
    flat["unified_lin/embedding"][:, 1:4] = 0.5  # moments, loaded whole with the table
    trainer = TorchSparseTrainer(port_model, device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce")
    trainer.init_state(point, seed=0)
    buffers = {path: t.data_ptr() for path, t in trainer.state.packed.items()}
    params_from_jax(flat, trainer)
    assert {path: t.data_ptr() for path, t in trainer.state.packed.items()} == buffers
    for path in ("unified_emb/embedding", "unified_lin/embedding"):
        np.testing.assert_array_equal(trainer.state.packed[path].numpy(), flat[path])
    np.testing.assert_array_equal(trainer.model.unified_lin.embedding.detach().numpy(),
                                  flat["unified_lin/embedding"][:, :1])
