"""``Trainer.compile(matmul_precision=...)`` on the CPU.

``"bfloat16"`` runs the train step's dense products (``ops/mlp.py``'s
linear layers, ``CrossNetworkFunction``'s backward GEMMs) on bf16-rounded
operands with f32 results. On the CPU that is the plain emulation, and the
port equals an emulation written out here exactly (``torch.equal``):
each product ``bf16(a) @ bf16(b)`` in f32, the backward's ``g @ W`` and
``g.T @ x`` (JAX's transposed dots) too, the bias gradient an f32 sum.

JAX on the CPU ignores ``default_matmul_precision("bfloat16")`` (its dots
stay f32), so the port's bf16 training is held to JAX's (and to its own
f32) within a stated bound instead: a small DCN-v2, 5 packed steps, each
step's loss within rtol 2e-3 and the scores after them within rtol 2e-2 /
atol 1e-4 (bf16 keeps 8 significant bits: 2**-9 relative a rounding).
Serving stays f32; an unknown precision raises; a recompile drops the
captured step layouts.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu.models import DCNv2
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2 as TorchDCNv2
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network, cross_network_backward
from pytorchrec_tpu_torch.ops.mlp import linear
from pytorchrec_tpu_torch.ops.precision import current_precision, matmul_precision
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH, STEPS, LR = 50, 3, 2, 64, 5, 1e-2
COMMON = dict(emb_size=4, num_cross_layers=2, layers=(8,))
LOSS_RTOL = 2e-3
SCORE_RTOL, SCORE_ATOL = 2e-2, 1e-4


def bf(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _tensors(seed, *shapes):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=gen) for s in shapes]


@pytest.mark.parametrize("lead", [(16,), (4, 5)])
def test_bf16_linear_is_the_emulation_forward_and_backward(lead):
    layer = linear(13, 7, device="cpu", generator=torch.Generator().manual_seed(1))
    x, g = _tensors(2, (*lead, 13), (*lead, 7))
    x.requires_grad_()
    with matmul_precision("bfloat16"):
        y = layer(x)
    y.backward(g)
    flat_x, flat_g = x.detach().reshape(-1, 13), g.reshape(-1, 7)
    w, b = layer.weight.detach(), layer.bias.detach()
    assert torch.equal(y.detach().reshape(-1, 7), torch.mm(bf(flat_x), bf(w).t()) + b)
    assert torch.equal(x.grad.reshape(-1, 13), torch.mm(bf(flat_g), bf(w)))
    assert torch.equal(layer.weight.grad, torch.mm(bf(flat_g).t(), bf(flat_x)))
    assert torch.equal(layer.bias.grad, flat_g.sum(dim=0))
    # outside the context the layer is nn.Linear's f32 product
    assert torch.equal(layer(x.detach()), torch.nn.functional.linear(x.detach(), w, b))
    assert not torch.equal(y.detach(), layer(x.detach()))


def test_bf16_cross_backward_is_the_emulation():
    x0, ws, bs, g = _tensors(3, (32, 9), (3, 9, 9), (3, 9), (32, 9))
    got = cross_network_backward(x0, ws, bs, g, "bfloat16")
    xs, us, xl = [], [], x0
    for layer in range(3):
        u = torch.mm(bf(xl), bf(ws[layer])) + bs[layer]
        xs.append(xl)
        us.append(u)
        xl = x0 * u + xl
    dx0, dws, dbs = torch.zeros_like(x0), [None] * 3, [None] * 3
    for layer in reversed(range(3)):
        gx0 = g * x0
        dws[layer] = torch.mm(bf(xs[layer].t()), bf(gx0))
        dbs[layer] = gx0.sum(dim=0)
        dx0 = dx0 + g * us[layer]
        g = torch.mm(bf(gx0), bf(ws[layer].t())) + g
    want = (dx0 + g, torch.stack(dws), torch.stack(dbs))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the autograd Function takes the forward's precision into its backward
    leaves = [t.clone().requires_grad_() for t in (x0, ws, bs)]
    with matmul_precision("bfloat16"):
        out = cross_network(*leaves)
    out.backward(_tensors(3, (32, 9), (3, 9, 9), (3, 9), (32, 9))[3])
    for leaf, b in zip(leaves, want):
        assert torch.equal(leaf.grad, b)
    assert current_precision() is None


def _batches(n=STEPS, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {f"c_{i}": rng.integers(0, VOCAB, BATCH).astype(np.int32)
                 for i in range(N_SPARSE)}
        batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32)
                      for i in range(N_DENSE)})
        batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
        out.append(batch)
    return out


def _port_model():
    return TorchDCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        unified_embedding=True, device="cpu", **COMMON)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's trainer compiled with matmul_precision="bfloat16" (f32 on the
    CPU): its initial leaves, each step's loss and the scores after."""
    batches = _batches()
    model = DCNv2(
        sparse_columns=tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                           category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        unified_embedding=True, **COMMON)
    trainer = SparseEmbeddingTrainer(model, packed_tables=True)
    trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=(),
                    matmul_precision="bfloat16")
    trainer.init_state(batches[0], seed=0)
    leaves = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(trainer.state.params), sep="/").items()}
    losses = [float(trainer._train_step(b)) for b in batches]
    serve = {k: v for k, v in _batches(1, seed=9)[0].items() if k != "label"}
    return leaves, losses, np.asarray(trainer.make_serving_fn()(serve)), serve


def _port_run(leaves, precision, batches):
    trainer = TorchSparseTrainer(_port_model(), device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=(),
                    matmul_precision=precision)
    trainer.init_state(batches[0], seed=0)
    params_from_jax(leaves, trainer)
    return trainer, [float(trainer.train_step(b)) for b in batches]


def test_bf16_training_within_its_bound_of_jax_and_f32(jax_run):
    leaves, jax_losses, jax_scores, serve = jax_run
    batches = _batches()
    bf16, bf16_losses = _port_run(leaves, "bfloat16", batches)
    f32, f32_losses = _port_run(leaves, None, batches)
    np.testing.assert_allclose(f32_losses, jax_losses, rtol=1e-5)
    np.testing.assert_allclose(bf16_losses, jax_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(bf16_losses, f32_losses, rtol=LOSS_RTOL)
    assert bf16_losses != f32_losses  # the products really ran in bf16
    scores = bf16.make_serving_fn()(serve).numpy()
    np.testing.assert_allclose(scores, jax_scores, rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_bf16_step_is_the_emulated_model_and_serving_stays_f32(jax_run):
    leaves, _, _, serve = jax_run
    batches = _batches(1)
    trainer = TorchSparseTrainer(_port_model(), device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=(),
                    matmul_precision="bfloat16")
    trainer.init_state(batches[0], seed=0)
    params_from_jax(leaves, trainer)
    model = trainer.model
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    with torch.no_grad():
        f32_prediction, target = model(batch, train=True)
        with matmul_precision("bfloat16"):
            bf16_prediction, _ = model(batch, train=True)
    # the first step's loss is the bf16 forward's, not the f32 one's
    loss = float(trainer.train_step(batches[0]))
    assert loss == float(trainer.loss_fn(bf16_prediction, target))
    assert loss != float(trainer.loss_fn(f32_prediction, target))
    # serving after training: the f32 forward of the trained model
    serve_batch = {k: torch.from_numpy(v) for k, v in serve.items()}
    with torch.no_grad():
        want, _ = model(serve_batch, train=False)
    assert torch.equal(trainer.make_serving_fn()(serve), want)
    assert current_precision() is None


@pytest.mark.parametrize("name", [None, "float32", "highest"])
def test_full_precision_names_are_f32(jax_run, name):
    leaves = jax_run[0]
    batches = _batches(2)
    _, losses = _port_run(leaves, name, batches)
    _, default = _port_run(leaves, None, batches)
    assert losses == default


@pytest.mark.parametrize("name", ["tensorfloat32", "bf16", "default", "high"])
def test_unknown_precision_raises(name):
    trainer = TorchSparseTrainer(_port_model(), device="cpu", packed_tables=True)
    with pytest.raises(ValueError, match="matmul_precision"):
        trainer.compile(optimizer="adam", loss="bce", matmul_precision=name)


def test_recompile_drops_the_captured_steps(jax_run):
    leaves = jax_run[0]
    batches = _batches(3)
    trainer, _ = _port_run(leaves, None, batches[:1])
    trainer.fit_steps(iter(batches), steps=3, log_every=3)
    assert trainer._layouts and trainer._layout is not None
    trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=(),
                    matmul_precision="bfloat16")
    assert not trainer._layouts and trainer._layout is None
    trainer.fit_steps(iter(batches), steps=3, log_every=3)
    assert trainer.state.step == 7 and len(trainer._layouts) == 1
