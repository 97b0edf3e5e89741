"""DLRM and its dot interaction on the CPU, the port against JAX.

``dot_interaction`` against the JAX op on the same numpy field vectors, with
and without ``self_interaction``, point-wise ``[B, F, E]`` and in candidate
mode ``[B, N, F, E]``; the triangle's order pinned to row-major
(``jnp.tril_indices``), which a column-major order would fail.

DLRM (3 sparse fields of vocab 50, E=4, 2 dense fields, bottom (8,), top
(16, 8)) initialised in JAX under the trainer of each table layout: per-field
and unified f32 tables (``Trainer``), int8 packed rows and the classic
``unified_q``/``unified_scale`` pair (``QuantizedEmbeddingTrainer``), with
and without dense columns; the f32 leaves are spread to N(0, 0.3) (at
N(0, 0.01) the interactions are four orders below the biases). The port's
model takes them through ``params_from_jax`` and scores the same point and
candidate batches as JAX's ``model.apply``.

Tolerances: f32 forward rtol 1e-5, with atol 1e-5 of the largest score
(sums over E and the MLPs' inputs run in another order in the two
frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models import DLRM
from pytorchrec_tpu.ops.interactions import dot_interaction as jax_dot_interaction
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.trainer import Trainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch import models as tmodels
from pytorchrec_tpu_torch.ops import dot_interaction
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import flax_path

VOCAB, N_SPARSE, N_DENSE, BATCH, E = 50, 3, 2, 16, 4
RTOL = 1e-5
ARCH = dict(emb_size=E, bottom_layers=(8,), top_layers=(16, 8))
# layout -> (model kwargs, JAX trainer)
LAYOUTS = {
    "per_field": ({}, Trainer),
    "unified_f32": ({"unified_embedding": True}, Trainer),
    "int8_packed": ({"unified_embedding": True, "quantized_embedding": True,
                     "table_packed": True},
                    lambda m: QuantizedEmbeddingTrainer(m, packed_tables=True)),
    "classic_int8": ({"unified_embedding": True, "quantized_embedding": True},
                     QuantizedEmbeddingTrainer),
}


def _columns(fc, n_dense=N_DENSE):
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(n_dense)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


def _batches(n_dense=N_DENSE):
    rng = np.random.default_rng(0)
    point = {f"c_{i}": rng.integers(0, VOCAB, BATCH).astype(np.int32) for i in range(N_SPARSE)}
    point.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32) for i in range(n_dense)})
    point["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
    # candidate rows: c_0 (and d_1) per candidate [B, N], the rest per row [B]
    cand = {f"c_{i}": rng.integers(0, VOCAB, (4, 7) if i == 0 else 4).astype(np.int32)
            for i in range(N_SPARSE)}
    if n_dense:
        cand.update({"d_0": rng.normal(size=4).astype(np.float32),
                     "d_1": rng.normal(size=(4, 7)).astype(np.float32)})
    return point, cand


def _spread(flat):
    """f32 leaves times 30: N(0, 0.3) weights and rows."""
    return {k: v * np.float32(30.0) if v.dtype == np.float32 else v for k, v in flat.items()}


def _jax_leaves(layout, n_dense=N_DENSE):
    kwargs, trainer_cls = LAYOUTS[layout]
    trainer = trainer_cls(DLRM(**_columns(jfc, n_dense), **ARCH, **kwargs))
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=())
    trainer.init_state(_batches(n_dense)[0], seed=0)
    flat = traverse_util.flatten_dict(jax.device_get(trainer.state.params), sep="/")
    return trainer.model, _spread({k: np.asarray(v) for k, v in flat.items()})


def _port_model(layout, n_dense=N_DENSE):
    return tmodels.DLRM(**_columns(tfc, n_dense), **ARCH, **LAYOUTS[layout][0], device="cpu",
                        generator=torch.Generator().manual_seed(0))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("shape", [(16, 6, 4), (3, 5, 6, 8), (1, 2, 3)])
def test_dot_interaction_matches_jax(shape, self_interaction):
    rng = np.random.default_rng(len(shape))
    v = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jax_dot_interaction(jnp.asarray(v), self_interaction))
    got = dot_interaction(torch.from_numpy(v), self_interaction)
    f = shape[-2]
    pairs = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    assert tuple(got.shape) == (*shape[:-2], pairs) == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_takes_the_lower_triangle_row_after_row(self_interaction):
    """Field vectors whose Gram entry (i, j) is 10 max(i, j) + min(i, j)
    (and 300 more on the diagonal, so the matrix is positive definite and V
    is its Cholesky factor): each output names its pair. The order is
    (i, j) for j < i (j <= i with the diagonal), i ascending, then j: JAX's
    ``tril_indices``. The column-major order differs, and would fail."""
    f = 5
    gram = np.array([[10 * max(i, j) + min(i, j) for j in range(f)] for i in range(f)],
                    np.float64) + 300 * np.eye(f)
    v = torch.from_numpy(np.linalg.cholesky(gram).astype(np.float32))[None]  # V V^T = gram
    got = dot_interaction(v, self_interaction)[0].round().to(torch.int64).tolist()
    k = 0 if self_interaction else -1
    row_major = [10 * i + j + (300 if i == j else 0)
                 for i in range(f) for j in range(f) if j <= i + k]
    col_major = [10 * i + j + (300 if i == j else 0)
                 for j in range(f) for i in range(f) if j <= i + k]
    assert got == row_major != col_major
    want = jax_dot_interaction(jnp.asarray(v.numpy()), self_interaction)[0]
    assert np.rint(np.asarray(want)).astype(np.int64).tolist() == row_major


@pytest.mark.parametrize("n_dense", [N_DENSE, 0])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dlrm_scores_match_jax(layout, n_dense):
    jax_model, flat = _jax_leaves(layout, n_dense)
    model = params_from_jax(flat, _port_model(layout, n_dense))
    serve = TorchTrainer(model, device="cpu").make_serving_fn()
    params = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                           for k, v in flat.items()})
    for batch in _batches(n_dense):
        request = {k: v for k, v in batch.items() if k != "label"}
        want, _ = jax_model.apply({"params": params}, request)
        got = serve(request)
        assert tuple(got.shape) == want.shape
        _close(got.numpy(), want)


def test_dlrm_leaves_and_init():
    """The port's parameters are the flax tree's leaves, one for one; the
    projections' biases start at zero, as flax's ``nn.Dense`` draws them."""
    _, flat = _jax_leaves("per_field")
    model = _port_model("per_field")
    assert {flax_path(k) for k in model.state_dict()} == set(flat)
    trainer = TorchTrainer(model, device="cpu")
    trainer.compile()
    trainer.init_state(_batches()[0], seed=3)
    assert not model.bottom_proj.bias.any() and not model.top_head.bias.any()
    assert model.top.layers[0].linear.bias.abs().sum() > 0
    assert tuple(model.top.layers[0].linear.weight.shape) == (16, E + 6)  # dense vector + 6 pairs
    no_dense = _port_model("unified_f32", n_dense=0)
    assert not hasattr(no_dense, "bottom")
    assert tuple(no_dense.top.layers[0].linear.weight.shape) == (16, 3)
