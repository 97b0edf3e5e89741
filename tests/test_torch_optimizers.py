"""The optimizer registry against optax, on the CPU: the port's
``build_optimizer`` against the JAX package's on the same leaves and
gradients, and each optimizer through the port's trainers against the JAX
trainers on a small DCN-v2.

* Registry level: ``sgd``, ``adam``, ``adamw`` and ``adagrad``, each
  without and with ``weight_decay`` (1e-2) and ``grad_clip_norm`` (1.0,
  which the N(0, 1) gradients' global norm of about 10 trips, and 1e3,
  which it does not), 5 steps at lr 1e-2 on leaves named as the multi-task
  family's (``experts/w_0``, ``experts/b_0``, ``head_0/kernel``,
  ``head_0/bias``, a tower's ``Dense_0/Dense_0/bias``): every leaf rtol
  1e-4 / atol 1e-6 against optax (f32 after N steps, ``ROADMAP.md``).
  adamw's mask goes by flax path: ``b_<i>`` is decayed, ``bias`` is not.
* Trainer level: each optimizer (with weight decay 1e-4 and the clip at
  1.0, and without either) through ``Trainer`` and
  ``SparseEmbeddingTrainer(packed_tables=True)`` on a DCN-v2 of 3 fields of
  vocab 50 (unified table, E=4), 2 dense fields, 2 cross layers, MLP (8,),
  5 steps of 32 rows from JAX's spread initial leaves (kernels N(0, 2 /
  fan_in), table N(0, 0.5): gradients away from Adam's eps window): losses
  rtol 1e-5, every parameter rtol 1e-4 / atol 1e-6. Under the sparse
  trainer the clip's norm covers the dense leaves only (JAX's
  ``optax.masked``), as the table keeps its own lazy Adam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models import DCNv2 as JaxDCNv2
from pytorchrec_tpu.optim import build_optimizer as jax_build_optimizer
from pytorchrec_tpu.optim import optimizer_name_list as jax_optimizer_names
from pytorchrec_tpu.training import Trainer as JaxTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer as JaxSparse
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.optim import Adagrad, build_optimizer, optimizer_name_list
from pytorchrec_tpu_torch.optim.optimizers import decays
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer, Trainer
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import leaves_of
from test_torch_reader_fit import _spread

STEPS, LR = 5, 1e-2
SHAPES = {"experts/w_0": (3, 4, 5), "experts/b_0": (3, 5), "head_0/kernel": (5, 1),
          "head_0/bias": (1,), "tower_0/Dense_0/Dense_0/bias": (4,)}
VARIANTS = {"plain": {}, "decay": dict(weight_decay=1e-2), "clip": dict(grad_clip_norm=1.0),
            "clip_idle": dict(grad_clip_norm=1e3),
            "decay_clip": dict(weight_decay=1e-2, grad_clip_norm=1.0)}


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed=1):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(STEPS)]


def _optax_run(name, kwargs, leaves, grads):
    tx = jax_build_optimizer(name, lr=LR, **kwargs)
    params = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                           for k, v in leaves.items()})
    state = tx.init(params)
    for g in grads:
        tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                             for k, v in g.items()})
        updates, state = tx.update(tree, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _port_run(name, kwargs, leaves, grads):
    params = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in leaves.values()]
    optimizer = build_optimizer(name, params, lr=LR, paths=list(leaves), **kwargs)
    for g in grads:
        for p, value in zip(params, g.values()):
            p.grad = torch.from_numpy(value.copy())
        optimizer.step()
    return {k: p.detach().numpy() for k, p in zip(leaves, params)}


def test_registry_names_match_jax():
    assert optimizer_name_list == list(jax_optimizer_names) == ["adagrad", "adam", "adamw", "sgd"]
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer("adamx", [], lr=LR)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "adagrad"])
def test_five_steps_match_optax(name, variant):
    leaves, grads = _leaves(), _grads()
    want = _optax_run(name, VARIANTS[variant], leaves, grads)
    got = _port_run(name, VARIANTS[variant], leaves, grads)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    moved = max(float(np.abs(got[k] - leaves[k]).max()) for k in leaves)
    assert moved > 0.0  # the steps did something


def test_adamw_decay_mask_goes_by_flax_path():
    """With zero gradients Adam's step is 0, so only the decoupled decay
    moves a value: ``experts/b_0`` and the kernels shrink by ``lr * wd``,
    every ``bias`` leaf stays; optax the same."""
    assert decays("experts/b_0") and decays("attention/b0") and decays("cross/bs")
    assert not decays("head_0/bias") and not decays("tower_0/Dense_0/Dense_0/bias")
    leaves = _leaves()
    zeros = [{k: np.zeros(s, np.float32) for k, s in SHAPES.items()}]
    got = _port_run("adamw", {"weight_decay": 0.5}, leaves, zeros)
    want = _optax_run("adamw", {"weight_decay": 0.5}, leaves, zeros)
    for key in SHAPES:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)
        if key.endswith("/bias"):
            np.testing.assert_array_equal(got[key], leaves[key])
        else:
            np.testing.assert_allclose(got[key], leaves[key] * (1 - LR * 0.5), rtol=1e-6)
    with pytest.raises(ValueError, match="flax path"):
        build_optimizer("adamw", [torch.nn.Parameter(torch.zeros(2))], lr=LR, weight_decay=0.1)


def test_adagrad_is_optax_not_torch():
    """The accumulator starts at 0.1 and eps sits inside the root: one step
    of gradient 1 moves a value by ``lr / sqrt(1.1 + 1e-10)``, where
    ``torch.optim.Adagrad`` (accumulator 0, eps outside) moves it by lr."""
    param = torch.nn.Parameter(torch.zeros(3))
    optimizer = build_optimizer("adagrad", [param], lr=LR, paths=["w"])
    assert isinstance(optimizer, Adagrad)
    torch.testing.assert_close(optimizer.state[param]["sum"], torch.full((3,), 0.1))
    param.grad = torch.ones(3)
    optimizer.step()
    torch.testing.assert_close(param.detach(), torch.full((3,), -LR / np.sqrt(1.1)),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# through the trainers
# ---------------------------------------------------------------------------

VOCAB, N_SPARSE, N_DENSE, BATCH, E = 50, 3, 2, 32, 4
ARCH = dict(emb_size=E, num_cross_layers=2, layers=(8,), unified_embedding=True)
TRAINERS = {"dense": (JaxTrainer, lambda m: Trainer(m, device="cpu")),
            "sparse": (lambda m: JaxSparse(m, packed_tables=True),
                       lambda m: SparseEmbeddingTrainer(m, device="cpu", packed_tables=True))}
EXTRAS = {"plain": {}, "decay_clip": dict(weight_decay=1e-4, grad_clip_norm=1.0)}


def _columns(fc):
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


def _batches(n=STEPS, seed=2):
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


def _flat(tree):
    tree = jax.device_get(tree)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("extra", list(EXTRAS))
@pytest.mark.parametrize("trainer", list(TRAINERS))
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "adagrad"])
def test_trainers_match_jax(name, trainer, extra):
    batches = _batches()
    jax_cls, port_cls = TRAINERS[trainer]
    compiled = dict(optimizer=name, lr=LR, loss="bce", metrics=(), **EXTRAS[extra])
    jax_trainer = jax_cls(JaxDCNv2(**_columns(jfc), **ARCH))
    jax_trainer.compile(**compiled)
    jax_trainer.init_state(batches[0], seed=0)
    flat = _spread(_flat(jax_trainer.state.params), E)
    jax_trainer.state = jax_trainer.state.replace(params=traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}))
    port = port_cls(DCNv2(**_columns(tfc), **ARCH, device="cpu"))
    port.compile(**compiled)
    port.init_state(batches[0], seed=0)
    params_from_jax(flat, port)
    for step, batch in enumerate(batches):
        np.testing.assert_allclose(float(port.train_step(batch)),
                                   float(jax_trainer._train_step(batch)), rtol=1e-5,
                                   err_msg=f"step {step}")
    want = _flat(jax_trainer.state.params)
    got = {k: v.numpy() for k, v in leaves_of(port).items()}
    assert set(got) <= set(want)
    for key, value in got.items():
        np.testing.assert_allclose(value, want[key], rtol=1e-4, atol=1e-6, err_msg=key)
