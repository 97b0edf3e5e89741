"""Serving from the classic quantized table (``table_packed=False``) on the
CPU: DCN-v2, FM and DeepFM scores from the port against JAX.

Small models (3 sparse fields of vocab 50, E=4, 2 dense fields, DCN-v2's 2
cross layers and MLP (8,), DeepFM's MLP (8,)) with the classic int8 table
(``unified_q`` int8 ``[V, 4]`` and ``unified_scale`` f32 ``[V]``), the int4
one (``[V, 2]`` nibble-packed) and two scale groups (``[V, 2]`` scales) are
initialised in JAX under ``QuantizedEmbeddingTrainer()`` (``init_state(seed=
0)``); their flax leaves load into the port with ``params_from_jax`` and the
port's ``Trainer.make_serving_fn()`` scores the same numpy batches as JAX's.

Tolerances: DCN-v2 rtol 1e-5 (atol 1e-8 for scores near zero), as
``tests/test_torch_dcnv2_serving.py``; FM and DeepFM within 1e-5 of the
terms' magnitude plus 1e-8, as ``tests/test_torch_deepfm_serving.py`` (a
score sums terms in another order in the two frameworks). The classic rows
dequantize exactly alike in both. A packed table's
``unpacked_quantized()`` triple loaded into a classic model scores exactly
as the packed model does.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu import models as jmodels
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch import models as tmodels
from pytorchrec_tpu_torch.models.ctr import _gather_fields
from pytorchrec_tpu_torch.ops.kernels.quantize import stochastic_quantize_rows
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH, E = 50, 3, 2, 16, 4
RTOL, ATOL = 1e-5, 1e-8
EXTRA = {"DCNv2": {"num_cross_layers": 2, "layers": (8,)}, "FM": {},
         "DeepFM": {"layers": (8,)}}
FORMATS = {"int8": (8, 1), "int4": (4, 1), "int8_2_groups": (8, 2)}


def _classic(fmt, packed=False):
    bits, groups = FORMATS[fmt]
    return dict(unified_embedding=True, quantized_embedding=True, table_packed=packed,
                table_bits=bits, scale_col_groups=groups)


def _columns(fc):
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


def _batches():
    rng = np.random.default_rng(0)
    point = {f"c_{i}": rng.integers(0, VOCAB, BATCH).astype(np.int32) for i in range(N_SPARSE)}
    point.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32) for i in range(N_DENSE)})
    # candidate rows: c_0 and d_1 per candidate [B, N], the rest per row [B]
    cand = {f"c_{i}": rng.integers(0, VOCAB, (4, 7) if i == 0 else 4).astype(np.int32)
            for i in range(N_SPARSE)}
    cand.update({"d_0": rng.normal(size=4).astype(np.float32),
                 "d_1": rng.normal(size=(4, 7)).astype(np.float32)})
    return point, cand


def _jax_trainer(name, fmt, sample, packed=False):
    model = getattr(jmodels, name)(**_columns(jfc), emb_size=E, **EXTRA[name],
                                   **_classic(fmt, packed))
    trainer = QuantizedEmbeddingTrainer(model, packed_tables=packed)
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=())
    trainer.init_state({**sample, "label": np.zeros(BATCH, np.int32)}, seed=0)
    return trainer


def _port_model(name, fmt, packed=False):
    return getattr(tmodels, name)(**_columns(tfc), emb_size=E, device="cpu",
                                  generator=torch.Generator().manual_seed(0), **EXTRA[name],
                                  **_classic(fmt, packed))


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _bound(model, batch, got):
    """ATOL + RTOL x the score's magnitude: DCN-v2's score itself; FM's and
    DeepFM's the sum of the absolute values of their parts."""
    if isinstance(model, tmodels.DCNv2):
        return ATOL + RTOL * np.abs(got)
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    sparse, dense, _ = _gather_fields(tensors, model.sparse_columns, model.dense_columns)
    with torch.no_grad():
        total = model.bias.abs() + sum((values * model.dense_linear[i]).abs()
                                       for i, values in enumerate(dense))
        total = total + model.unified_lin(model._unified_ids(sparse)).abs().sum(dim=(-2, -1))
        v = model._field_vectors(sparse, dense, tensors)
        total = total + 0.5 * (v.sum(dim=-2).square() + v.square().sum(dim=-2)).sum(dim=-1)
        if isinstance(model, tmodels.DeepFM):
            total = total + model.deep_head(model.deep(v.reshape(*v.shape[:-2], -1))).abs()[..., 0]
    return ATOL + RTOL * total.numpy()


@pytest.mark.parametrize("mode", ["pointwise", "candidates"])
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("name", list(EXTRA))
def test_classic_scores_match_jax(name, fmt, mode):
    point, cand = _batches()
    jax_trainer = _jax_trainer(name, fmt, point)
    batch = point if mode == "pointwise" else cand
    want = np.asarray(jax_trainer.make_serving_fn()(batch))
    flat = _flat(jax_trainer.state.params)
    bits, groups = FORMATS[fmt]
    assert flat["unified_q"].dtype == np.int8
    assert flat["unified_q"].shape == (N_SPARSE * VOCAB, E if bits == 8 else E // 2)
    assert flat["unified_scale"].shape == ((N_SPARSE * VOCAB,) if groups == 1
                                           else (N_SPARSE * VOCAB, groups))

    model = params_from_jax(flat, _port_model(name, fmt))
    np.testing.assert_array_equal(model.unified_q.numpy(), flat["unified_q"])
    np.testing.assert_array_equal(model.unified_scale.numpy(), flat["unified_scale"])
    before = stochastic_quantize_rows.launches
    got = TorchTrainer(model, device="cpu").make_serving_fn()(batch)
    assert stochastic_quantize_rows.launches == before  # serving never quantizes
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want)
    assert (err <= _bound(model, batch, got.numpy())).all(), err.max()


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_a_packed_tables_unpacked_triple_scores_as_the_packed_model(fmt):
    """JAX's packed table after a step, through ``unpacked_quantized()``,
    into a classic port model: the same scores as the packed port model."""
    point, cand = _batches()
    jax_trainer = _jax_trainer("DeepFM", fmt, point, packed=True)
    jax_trainer._train_step({**point, "label": np.arange(BATCH, dtype=np.int32) % 2})
    flat = _flat(jax_trainer.state.params)
    packed = params_from_jax(flat, _port_model("DeepFM", fmt, packed=True))
    q, scale, acc = (np.asarray(a) for a in jax_trainer.unpacked_quantized()["unified"])
    assert acc.max() > 0  # the step moved the table
    classic_flat = {k: v for k, v in flat.items() if k != "unified_q"}
    classic_flat.update(unified_q=q, unified_scale=scale)
    classic = params_from_jax(classic_flat, _port_model("DeepFM", fmt))
    for batch in (point, cand):
        want = TorchTrainer(packed, device="cpu").make_serving_fn()(batch)
        got = TorchTrainer(classic, device="cpu").make_serving_fn()(batch)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_the_classic_table_and_its_protocol():
    point, _ = _batches()
    model = _port_model("DCNv2", "int8")
    assert model.unified_q.dtype == torch.int8 and model.unified_q.shape == (N_SPARSE * VOCAB, E)
    assert model.unified_scale.dtype == torch.float32
    assert {"unified_q", "unified_scale"} <= set(model.state_dict())
    assert not any(n.startswith("unified_") for n, _ in model.named_parameters())
    spec = model.quantized_table_spec(point)["unified"]
    assert (spec["q"], spec["scale"], spec["packed"]) == ("unified_q", "unified_scale", False)
    rows = model.unified_q.float() * model.unified_scale[:, None]
    assert 0.005 < float(rows.std()) < 0.02  # normal(0, 0.01), quantized
    int4 = _port_model("FM", "int4")
    assert int4.unified_q.shape == (N_SPARSE * VOCAB, E // 2)
    assert _port_model("FM", "int8_2_groups").unified_scale.shape == (N_SPARSE * VOCAB, 2)


def test_the_converter_holds_classic_leaves_to_the_buffers():
    point, _ = _batches()
    flat = _flat(_jax_trainer("DCNv2", "int8", point).state.params)
    for key, bad in (("unified_q", flat["unified_q"].view(np.uint8)),
                     ("unified_scale", flat["unified_scale"][:, None])):
        with pytest.raises(ValueError):
            params_from_jax({**flat, key: bad}, _port_model("DCNv2", "int8"))
    with pytest.raises((KeyError, ValueError)):  # classic leaves into a packed model
        params_from_jax({**flat}, _port_model("DCNv2", "int8", packed=True))
    trainer = TorchQuantizedTrainer(_port_model("DCNv2", "int8"), device="cpu")
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce")
    trainer.init_state({**point, "label": np.zeros(BATCH, np.int32)}, seed=0)
    q = trainer.model.unified_q
    params_from_jax(flat, trainer)  # into the trainer: the model's own buffers, in place
    assert trainer.model.unified_q.data_ptr() == q.data_ptr()
    np.testing.assert_array_equal(q.numpy(), flat["unified_q"])
