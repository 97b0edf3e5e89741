"""DCN-v2 past the fused cross form's width, on the CPU: the port against JAX.

The Criteo layout at E=64 (26 sparse fields, 13 dense), so the cross
network's width is D = 26 * 64 + 13 = 1677, as in the repo's E=64
configuration (``scripts/int8_e64_ab.py``), cut to a vocab of 40 a field,
MLP (16,) and 16 rows. The model is initialised in JAX under the trainer
that owns each table layout, its flax leaves are converted with
``params_from_jax`` and the port's ``Trainer.make_serving_fn()`` scores the
same numpy batch as JAX's. Tolerance rtol 1e-5 (atol 1e-8 for scores near
zero): f32 matmuls sum in another order.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu.models import DCNv2
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2 as TorchDCNv2
from pytorchrec_tpu_torch.ops.kernels.cross import FUSED_MAX_WIDTH, cross_network, cross_plan
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, EMB, BATCH = 40, 26, 13, 64, 16
DIM = N_SPARSE * EMB + N_DENSE  # 1677
RTOL, ATOL = 1e-5, 1e-8
COMMON = dict(emb_size=EMB, num_cross_layers=3, layers=(16,), unified_embedding=True)
LAYOUTS = {
    "packed_f32": ({}, lambda m: SparseEmbeddingTrainer(m, packed_tables=True)),
    "int8_packed": ({"quantized_embedding": True, "table_packed": True},
                    lambda m: QuantizedEmbeddingTrainer(m, packed_tables=True)),
}


def _batch():
    rng = np.random.default_rng(11)
    batch = {f"c_{i}": rng.integers(0, VOCAB, BATCH).astype(np.int32) for i in range(N_SPARSE)}
    batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32) for i in range(N_DENSE)})
    batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
    return batch


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_wide_dcnv2_serving_matches_jax(layout):
    kwargs, make_trainer = LAYOUTS[layout]
    sample = _batch()
    model = DCNv2(
        sparse_columns=tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                           category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        **COMMON, **kwargs)
    trainer = make_trainer(model)
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce")
    trainer.init_state(sample, seed=0)
    request = {k: v for k, v in sample.items() if k != "label"}
    want = np.asarray(trainer.make_serving_fn()(request))

    params = jax.device_get(trainer.state.params)
    leaves = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    assert leaves["cross/ws"].shape == (3, DIM, DIM)
    port = TorchDCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        device="cpu", generator=torch.Generator().manual_seed(0), **COMMON, **kwargs)
    port = params_from_jax(leaves, port)
    before = cross_network.launches
    got = TorchTrainer(port, device="cpu").make_serving_fn()(request)
    assert cross_network.launches == before  # CPU: the plain version, no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # on the card this width runs the tiled form at every batch
    assert DIM > FUSED_MAX_WIDTH
    assert all(cross_plan(rows, DIM).form == "tiled" for rows in (1, BATCH, 32768))
