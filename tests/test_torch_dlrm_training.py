"""DLRM training on the CPU under the three table trainers, the port against
JAX.

A small DLRM (3 sparse fields of vocab 50 on a unified table, E=4, 2 dense
fields, bottom (8,), top (16, 8)) is set up in JAX with
``compile("adam", lr=1e-2, loss="bce")`` and ``init_state(seed=0)`` under

* ``SparseEmbeddingTrainer(packed_tables=True)``: the packed f32
  ``[V, 64]`` leaf under lazy Adam;
* ``QuantizedEmbeddingTrainer(packed_tables=True)``: int8 ``unified_q``
  byte rows;
* ``QuantizedEmbeddingTrainer()``: the classic ``unified_q`` and
  ``unified_scale`` pair and the state's accumulator;

its leaves load into the port's trainer (``params_from_jax``) and both take
5 steps on the same batches. Zipf-skewed batches (seed 2, as
``tests/test_torch_deepfm_training.py``): each loss rtol 1e-5; dense
parameters rtol 1e-4 / atol 1e-6; the f32 table rtol 1e-4 / atol 1e-6
outside Adam's eps window (``sqrt(v_hat) < 1e-6``, C7's rule: within 5
steps of lr there); int8 rows' scale and accumulator rtol 1e-4 / atol 1e-6
and their q values off by at most one in at most 0.1% of them. Batches whose
ids are unique within each field (no duplicate sums): the first step's q
bytes JAX's byte for byte, later steps at most one q value a step off by one
(``test_int8_rows_byte_exact_on_unique_ids`` says why).
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models import DLRM
from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch import models as tmodels
from pytorchrec_tpu_torch.ops.kernels.quantize import requantize_rows, stochastic_quantize_rows
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH, STEPS, LR, E = 50, 3, 2, 32, 5, 1e-2, 4
ARCH = dict(emb_size=E, bottom_layers=(8,), top_layers=(16, 8), unified_embedding=True)
KERNELS = (segmented_sum_scan, requantize_rows, scatter_set_rows, stochastic_quantize_rows)
# table format -> (model kwargs, JAX trainer, port trainer)
FORMATS = {
    "packed_f32": ({}, lambda m: SparseEmbeddingTrainer(m, packed_tables=True),
                   lambda m: TorchSparseTrainer(m, device="cpu", packed_tables=True)),
    "int8_packed": ({"quantized_embedding": True, "table_packed": True},
                    lambda m: QuantizedEmbeddingTrainer(m, packed_tables=True),
                    lambda m: TorchQuantizedTrainer(m, device="cpu", packed_tables=True)),
    "classic_int8": ({"quantized_embedding": True}, QuantizedEmbeddingTrainer,
                     lambda m: TorchQuantizedTrainer(m, device="cpu")),
}


def _columns(fc):
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


def _batches(unique: bool, n=STEPS, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if unique:  # each id at most once in a field
            batch = {f"c_{i}": rng.permutation(VOCAB)[:BATCH].astype(np.int32)
                     for i in range(N_SPARSE)}
        else:  # skewed towards a few hot ids, runs of 10+
            batch = {f"c_{i}": np.minimum(rng.zipf(1.5, BATCH) - 1, VOCAB - 1).astype(np.int32)
                     for i in range(N_SPARSE)}
        batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32)
                      for i in range(N_DENSE)})
        batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
        out.append(batch)
    return out


def _flat(tree):
    tree = jax.device_get(tree)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _port_model(table):
    return tmodels.DLRM(**_columns(tfc), **ARCH, **FORMATS[table][0], device="cpu",
                        generator=torch.Generator().manual_seed(0))


def _pair(table, batches):
    kwargs, jax_cls, port_cls = FORMATS[table]
    jax_trainer = jax_cls(DLRM(**_columns(jfc), **ARCH, **kwargs))
    jax_trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    port = port_cls(_port_model(table))
    port.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    port.init_state(batches[0], seed=0)
    params_from_jax(_flat(jax_trainer.state.params), port)
    return jax_trainer, port


def _triples(table, jax_trainer, port):
    """(q, scale, acc) of the port's table and of JAX's, as numpy."""
    if table == "int8_packed":
        got = port.unpacked_quantized()["unified"]
        want = jqp.unpack_quantized_table(_flat(jax_trainer.state.params)["unified_q"], E, 8, 1)
    else:
        flat = _flat(jax_trainer.state.params)
        got = (port.model.unified_q, port.model.unified_scale, port.state.table_acc["unified"])
        want = (flat["unified_q"], flat["unified_scale"],
                jax_trainer.state.table_acc["unified"])
    return [np.asarray(a) for a in got], [np.asarray(a) for a in want]


def _run(table, unique):
    batches = _batches(unique)
    jax_trainer, port = _pair(table, batches)
    before = [k.launches for k in KERNELS]
    for step, batch in enumerate(batches):
        want = float(jax_trainer._train_step(batch))
        np.testing.assert_allclose(float(port.train_step(batch)), want, rtol=1e-5,
                                   err_msg=f"step {step}")
    assert [k.launches for k in KERNELS] == before  # the CPU runs the plain versions
    return jax_trainer, port


@pytest.mark.parametrize("table", list(FORMATS))
def test_five_dlrm_steps_match_jax(table):
    jax_trainer, port = _run(table, unique=False)
    flat = _flat(jax_trainer.state.params)
    tables = {"unified_emb/embedding", "unified_q", "unified_scale"}
    want = params_from_jax({k: v for k, v in flat.items()}, _port_model(table)).state_dict()
    for key, value in port.model.state_dict().items():
        if key.replace(".", "/") not in tables:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)
    if table == "packed_f32":
        path = "unified_emb/embedding"
        got, want = port.state.packed[path].numpy(), flat[path]
        window = np.sqrt(want[:, 2 * E:3 * E] / (1.0 - 0.999 ** STEPS)) < 1e-6
        np.testing.assert_allclose(got[:, :E][~window], want[:, :E][~window], rtol=1e-4,
                                   atol=1e-6)
        assert (np.abs(got[:, :E] - want[:, :E])[window] <= STEPS * LR).all()
        np.testing.assert_allclose(got[:, E:], want[:, E:], rtol=1e-4, atol=1e-6)
    else:
        (gq, gs, ga), (wq, ws, wa) = _triples(table, jax_trainer, port)
        diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
        assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000)
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ga, wa, rtol=1e-4, atol=1e-6)
    serve_batch = {k: v for k, v in _batches(False, 1, seed=7)[0].items() if k != "label"}
    np.testing.assert_allclose(port.make_serving_fn()(serve_batch).numpy(),
                               np.asarray(jax_trainer.make_serving_fn()(serve_batch)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("table", ["int8_packed", "classic_int8"])
def test_int8_rows_byte_exact_on_unique_ids(table):
    """Ids unique within each field, so no duplicate's grads are summed: the
    first step's q bytes are JAX's byte for byte; from the second step on,
    the dense parameters' last bits (the interaction's backward is a
    ``bmm`` here and an einsum there) reach the rows, and a q value at a
    rounding threshold may round the other way: at most one a step, by one.
    Scales and accumulators rtol 1e-4 / atol 1e-6 throughout."""
    batches = _batches(unique=True)
    jax_trainer, port = _pair(table, batches)
    for step, batch in enumerate(batches):
        np.testing.assert_allclose(float(port.train_step(batch)),
                                   float(jax_trainer._train_step(batch)), rtol=1e-5)
        (gq, gs, ga), (wq, ws, wa) = _triples(table, jax_trainer, port)
        diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
        assert diff.max() <= 1 and int((diff > 0).sum()) <= step, (step, int(diff.sum()))
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ga, wa, rtol=1e-4, atol=1e-6)
