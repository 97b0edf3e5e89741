"""The zoo's leaves through ``utils/convert.py`` on the CPU: every flax leaf
of FunkSVD, SVD++, NCF, GRU4Rec and SASRec (shared and per-layer blocks)
has a port key and back, under the dense trainer, the packed f32 trainer
and the int8 packed trainer.

* ``leaves_of`` names exactly the JAX trainer's leaves, each of its shape
  and dtype; JAX's leaves load with ``load_leaves`` in place (no tensor
  moves); ``leaves_of`` → ``load_leaves`` into a trainer from another seed
  gives every leaf back bit for bit, and a weights file does too.
* A checkpoint of an int8 SVD++ trainer (two salted packed tables, dense
  Adam over the user table, the biases and ``global_bias``) restores in
  place into a trainer from another seed that has stepped: every
  ``data_ptr()`` unchanged, every value equal, and the next step of both
  bit-equal.
* A leaf the port does not know still raises.

The models and batches are ``tests/test_torch_zoo_models.py``'s.
"""

import numpy as np
import pytest
import torch

from test_torch_zoo_models import LAYOUTS, MODELS, flat, jax_model, make_batch, port_model
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer, SparseEmbeddingTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import flax_path, leaves_of, load_leaves

PORT_TRAINERS = {"f32": TorchTrainer,
                 "packed_f32": lambda m, **k: SparseEmbeddingTrainer(m, packed_tables=True, **k),
                 "int8_packed": lambda m, **k: QuantizedEmbeddingTrainer(m, packed_tables=True,
                                                                         **k)}


def _sample():
    return make_batch(np.random.default_rng(0), candidates=2, label="pair")


def _jax_leaves(name, layout):
    kwargs, make = LAYOUTS[layout]
    trainer = make(jax_model(name, **kwargs))
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=())
    trainer.init_state(_sample(), seed=0)
    return flat(trainer.state.params)


def _trainer(name, layout, seed=0):
    kwargs = LAYOUTS[layout][0]
    trainer = PORT_TRAINERS[layout](port_model(name, seed=seed, **kwargs), device="cpu")
    trainer.compile(optimizer="adam", lr=1e-3, loss="bpr" if name in ("funk_svd", "svdpp",
                                                                     "ncf") else "bce")
    trainer.init_state(_sample(), seed=seed)
    return trainer


def _tensors(trainer):
    out = {f"param {k}": v for k, v in trainer.model.state_dict().items()}
    out.update({f"packed {k}": v for k, v in getattr(trainer.state, "packed", {}).items()})
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for param, entry in trainer.state.optimizer.state.items():
        out.update({f"opt {names[id(param)]} {k}": v for k, v in entry.items()})
    return out


def _pointers(trainer):
    return {k: v.data_ptr() for k, v in _tensors(trainer).items()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(MODELS))
def test_every_leaf_round_trips(name, layout, tmp_path):
    want = _jax_leaves(name, layout)
    trainer = _trainer(name, layout)
    got = leaves_of(trainer)
    assert set(got) == set(want)
    for path, value in got.items():
        assert tuple(value.shape) == want[path].shape, path
        assert str(value.dtype).split(".")[-1] == str(want[path].dtype), path
    assert {flax_path(key) for key in trainer.model.state_dict()} == set(want)
    pointers = _pointers(trainer)
    params_from_jax(want, trainer)  # JAX's own leaves, in place
    assert _pointers(trainer) == pointers
    for path, value in leaves_of(trainer).items():
        np.testing.assert_array_equal(value.numpy(), want[path], err_msg=path)

    other = _trainer(name, layout, seed=7)
    other_pointers = _pointers(other)
    load_leaves(leaves_of(trainer), other)
    assert _pointers(other) == other_pointers
    for path, value in leaves_of(other).items():
        np.testing.assert_array_equal(value.numpy(), want[path], err_msg=path)
    path = str(tmp_path / "weights.pt")
    trainer.save_weights(path)
    third = _trainer(name, layout, seed=8)
    third.load_weights(path)
    for key, value in leaves_of(third).items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


def test_int8_svdpp_checkpoint_restores_in_place(tmp_path):
    batches = [make_batch(np.random.default_rng(seed), candidates=2, label="pair")
               for seed in range(3)]
    a = _trainer("svdpp", "int8_packed")
    assert sorted(a.state.packed) == ["i_q", "implicit_i_q"]
    for batch in batches[:2]:
        a.train_step(batch)
    path = str(tmp_path / "svdpp.pt")
    a.save_checkpoint(path)
    b = _trainer("svdpp", "int8_packed", seed=5)  # other weights and rounding key
    b.train_step(batches[2])  # its optimizer has state
    pointers = _pointers(b)
    b.restore_checkpoint(path)
    assert _pointers(b) == pointers
    assert b.state.step == a.state.step == 2
    assert np.array_equal(b.state.rng_key, a.state.rng_key)
    for key, value in _tensors(a).items():
        assert torch.equal(_tensors(b)[key], value), key
    assert torch.equal(a.train_step(batches[2]), b.train_step(batches[2]))
    for key, value in _tensors(a).items():
        assert torch.equal(_tensors(b)[key], value), key


@pytest.mark.parametrize("leaf", ["block_shared/V/kernel", "block_shared/LayerNorm_1/scale",
                                  "rnn/w_xh", "implicit_q", "block_shared/Q/bias"])
def test_unknown_zoo_leaves_raise(leaf):
    name = "svdpp" if leaf == "implicit_q" else ("gru4rec" if leaf.startswith("rnn")
                                                  else "sasrec")
    want = _jax_leaves(name, "f32")
    with pytest.raises(KeyError):
        params_from_jax({**want, leaf: np.zeros((8, 8), np.float32)}, port_model(name))
    with pytest.raises(KeyError):  # a port parameter no leaf fills
        params_from_jax({k: v for k, v in want.items() if k != sorted(want)[0]},
                        port_model(name))
