"""The slice end to end on the CPU: LR, FM and DeepFM scores from the port
against JAX.

Small models (3 sparse fields of vocab 50, E=4, 2 dense fields, DeepFM's MLP
(8,)) are initialised in JAX (``init_state(seed=0)``) under the trainer that
owns each table layout: per-field and unified f32 tables under ``Trainer``,
packed f32 leaves (``unified_emb`` and ``unified_lin``, ``[V, 64]`` each)
under ``SparseEmbeddingTrainer(packed_tables=True)``, the int8 packed
``unified_q`` beside the f32 ``unified_lin`` under
``QuantizedEmbeddingTrainer(packed_tables=True)``. Their flax leaves are
converted with ``params_from_jax`` and the port's
``Trainer.make_serving_fn()`` scores the same numpy point and candidate
batches as JAX's ``make_serving_fn()``.

Tolerance: within 1e-5 of the terms' magnitude, plus atol 1e-8. A score is
a sum of terms (bias, linear rows, dense terms, the FM term's two sums, the
deep tower) run in another order in the two frameworks; the magnitude is
the sum of their absolute values, bounded here by the sum of the absolute
scores of the model's parts, which the test recomputes from the port's own
modules.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models import FM, LR, DeepFM
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu.training.trainer import Trainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch import models as tmodels
from pytorchrec_tpu_torch.models.ctr import _gather_fields
from pytorchrec_tpu_torch.ops.kernels import fm as fm_kernels
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH = 50, 3, 2, 16
RTOL, ATOL = 1e-5, 1e-8
MODELS = {"LR": (LR, {}), "FM": (FM, {}), "DeepFM": (DeepFM, {"layers": (8,)})}

# layout -> (model kwargs, JAX trainer)
LAYOUTS = {
    "per_field": ({}, Trainer),
    "unified_f32": ({"unified_embedding": True}, Trainer),
    "packed_f32": ({"unified_embedding": True},
                   lambda m: SparseEmbeddingTrainer(m, packed_tables=True)),
    "int8_packed": ({"unified_embedding": True, "quantized_embedding": True,
                     "table_packed": True},
                    lambda m: QuantizedEmbeddingTrainer(m, packed_tables=True)),
}
CASES = [(m, layout) for m in MODELS for layout in LAYOUTS
         if not (m == "LR" and layout == "int8_packed")]  # LR has no field table to quantize


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


def _columns(fc):
    """The columns, from the JAX package's ``feature_column`` or the port's."""
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


def _jax_trainer(name, layout, sample):
    cls, extra = MODELS[name]
    kwargs, make_trainer = LAYOUTS[layout]
    trainer = make_trainer(cls(**_columns(jfc), emb_size=4, **extra, **kwargs))
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=("auc",))
    trainer.init_state(sample, seed=0)
    return trainer


def _port_model(name, layout):
    _, extra = MODELS[name]
    kwargs, _ = LAYOUTS[layout]
    return getattr(tmodels, name)(**_columns(tfc), emb_size=4, device="cpu",
                                  generator=torch.Generator().manual_seed(0), **extra, **kwargs)


def _flat_leaves(trainer):
    params = jax.device_get(trainer.state.params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _magnitude(model, batch):
    """Per score: the sum of the absolute values of its parts (linear term
    terms, the FM term's two sums, the deep tower), from the port's modules."""
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    sparse, dense, _ = _gather_fields(tensors, model.sparse_columns, model.dense_columns)
    with torch.no_grad():
        total = model.bias.abs() + sum((values * model.dense_linear[i]).abs()
                                       for i, values in enumerate(dense))
        if model.unified_embedding:
            total = total + model.unified_lin(model._unified_ids(sparse)).abs().sum(dim=(-2, -1))
        else:
            total = total + sum(emb(ids)[..., 0].abs() for emb, ids in
                                zip(model.first_order, sparse))
        if model._uses_field_embeddings:
            v = model._field_vectors(sparse, dense, tensors)
            total = total + 0.5 * (v.sum(dim=-2).square() + v.square().sum(dim=-2)).sum(dim=-1)
            if isinstance(model, tmodels.DeepFM):
                flat = v.reshape(*v.shape[:-2], -1)
                total = total + model.deep_head(model.deep(flat)).abs()[..., 0]
    return total.numpy()


@pytest.mark.parametrize("mode", ["pointwise", "candidates"])
@pytest.mark.parametrize("name,layout", CASES)
def test_port_serving_matches_jax(name, layout, mode):
    point, cand = _batches()
    jax_trainer = _jax_trainer(name, layout, point)
    batch = point if mode == "pointwise" else cand
    if mode == "pointwise":
        batch = {k: v for k, v in batch.items() if k != "label"}  # serving needs no label
    want = np.asarray(jax_trainer.make_serving_fn()(batch))

    model = params_from_jax(_flat_leaves(jax_trainer), _port_model(name, layout))
    before = (fm_kernels.fm_interaction.launches, fm_kernels.fm_interaction_backward.launches)
    got = TorchTrainer(model, device="cpu").make_serving_fn()(batch)
    # CPU: the plain versions, no launch
    assert (fm_kernels.fm_interaction.launches,
            fm_kernels.fm_interaction_backward.launches) == before
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    bound = ATOL + RTOL * _magnitude(model, batch)
    assert (np.abs(got.numpy() - want) <= bound).all(), np.abs(got.numpy() - want).max()


@pytest.mark.parametrize("name", list(MODELS))
def test_models_create_only_what_they_read(name):
    keys = set(_port_model(name, "unified_f32").state_dict())
    assert {"bias", "dense_linear", "unified_lin.embedding"} <= keys
    assert ("unified_emb.embedding" in keys) == (name != "LR")
    assert ("dense_factors" in keys) == (name != "LR")
    assert ("deep_head.weight" in keys) == (name == "DeepFM")
    per_field = set(_port_model(name, "per_field").state_dict())
    assert {f"lin_c_{i}.embedding" for i in range(N_SPARSE)} <= per_field
    assert ({f"emb_c_{i}.embedding" for i in range(N_SPARSE)} <= per_field) == (name != "LR")
    dcn = tmodels.DCNv2(**_columns(tfc), emb_size=4, unified_embedding=True, device="cpu")
    assert not {"bias", "dense_linear", "dense_factors", "unified_lin.embedding"} & set(
        dcn.state_dict())
    with pytest.raises(ValueError):
        _port_model("LR", "int8_packed")


def test_deepfm_tables_name_both_unified_tables():
    point, _ = _batches()
    model = _port_model("DeepFM", "unified_f32")
    specs = model.sharded_table_specs(point)
    assert [s["path"] for s in specs.values()] == ["unified_lin/embedding",
                                                  "unified_emb/embedding"]
    assert [s["rows_key"] for s in specs.values()] == ["__rows__unified_lin", "__rows__unified"]
    assert set(model.sparse_table_ids(point)) == {"unified_lin/embedding",
                                                  "unified_emb/embedding"}
    lr = _port_model("LR", "unified_f32")
    assert [s["path"] for s in lr.sharded_table_specs(point).values()] == [
        "unified_lin/embedding"]
    quantized = _port_model("DeepFM", "int8_packed")
    assert [s["q"] for s in quantized.quantized_table_spec(point).values()] == ["unified_q"]


def test_injected_rows_replace_the_gathers():
    """Rows under ``ROWS_KEY`` and ``LIN_ROWS_KEY`` give the scores of the
    model's own gathers."""
    point, _ = _batches()
    model = _port_model("DeepFM", "unified_f32")
    with torch.no_grad():
        want, _ = model(point)
        ids = model._unified_ids(_gather_fields({k: torch.as_tensor(v) for k, v in point.items()},
                                                model.sparse_columns, ())[0]).reshape(-1)
        injected = dict(point)
        injected[model.ROWS_KEY] = model.unified_emb.embedding[ids]
        injected[model.LIN_ROWS_KEY] = model.unified_lin.embedding[ids]
        got, _ = model(injected)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
