"""Weights, best weights and full-state checkpoints of the port, restored in
place, on the CPU; ``training/checkpoint.py``'s manager, callback and
preemption guard.

A small DCN-v2 (3 sparse fields of vocab 50, E=8, 2 dense fields, 2 cross
layers, MLP (8,)) trains through ``fit`` in three table formats (packed
f32 rows, packed int8 rows, the classic int8 ``q`` and ``scale`` with their
accumulator) and, packed f32, with dropout 0.3 in its MLP.

* A weights file names the JAX leaves: its keys are the flax paths of the
  JAX trainer's ``state.params`` (less the unread DCN-v2 leaves), each of
  the same shape and dtype, and JAX's own leaves load the same way.
* Every load (``load_weights``, ``load_best_weights``,
  ``restore_checkpoint``) leaves each tensor where it was: the same
  ``data_ptr()`` for every parameter, buffer, packed table, accumulator and
  optimizer state tensor, which is what a captured CUDA graph reads.
* A resumed run is bit-equal to the uninterrupted one: run A takes 2 epochs
  and then 1; run B takes 2, saves a checkpoint, and a trainer made from
  another seed (other weights, generator and rounding key; it has trained
  an epoch already, so its optimizer has state) restores it and takes 1:
  every loss and every value of the state equal, bit for bit.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models import DCNv2 as JaxDCNv2
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer as JaxQuantized
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer as JaxSparse
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.data import TrainMode
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.training import (
    Callback,
    CheckpointCallback,
    CheckpointManager,
    PreemptionGuard,
    QuantizedEmbeddingTrainer,
    SparseEmbeddingTrainer,
)
from pytorchrec_tpu_torch.utils.convert import UNREAD_LEAVES, load_leaves

VOCAB, N_SPARSE, N_DENSE, E, LR, BATCH = 50, 3, 2, 8, 1e-2, 32
FORMATS = {"f32": dict(unified_embedding=True),
           "int8": dict(unified_embedding=True, quantized_embedding=True, table_packed=True),
           "classic": dict(unified_embedding=True, quantized_embedding=True)}
CASES = {"f32": ("f32", 0.0), "int8": ("int8", 0.0), "classic": ("classic", 0.0),
         "dropout": ("f32", 0.3)}


class ArrayReader:
    train_mode = TrainMode.POINT_WISE

    def __init__(self, splits):
        self.splits = splits

    def get_dataset_size(self, split):
        return len(self.splits[split]["label"])

    def get_train_dataset_size(self):
        return self.get_dataset_size("train")

    def get_batch(self, split, indices):
        return {k: v[indices] for k, v in self.splits[split].items()}


def _split(rng, rows):
    split = {f"c_{i}": np.minimum(rng.zipf(1.5, rows) - 1, VOCAB - 1).astype(np.int64)
             for i in range(N_SPARSE)}
    split.update({f"d_{i}": rng.normal(size=rows).astype(np.float32) for i in range(N_DENSE)})
    split["label"] = rng.integers(0, 2, rows).astype(np.int32)
    return split


def _reader():
    rng = np.random.default_rng(4)
    return ArrayReader({"train": _split(rng, 128), "dev": _split(rng, 48)})


def _columns(fc):
    return dict(sparse_columns=[fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                                 category_num=VOCAB)
                                for i in range(N_SPARSE)],
                dense_columns=[fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
                label_column=fc.CategoricalColumnWithIdentity(feature_name="label",
                                                              category_num=2))


def _trainer(case, seed=0, init=True):
    table, dropout = CASES[case]
    model = DCNv2(**_columns(tfc), emb_size=E, num_cross_layers=2, layers=(8,), dropout=dropout,
                  device="cpu", generator=torch.Generator().manual_seed(seed), **FORMATS[table])
    if table == "f32":
        trainer = SparseEmbeddingTrainer(model, device="cpu", packed_tables=True)
    else:
        trainer = QuantizedEmbeddingTrainer(model, device="cpu", packed_tables=table == "int8")
    trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=("auc", "logloss"))
    if init:
        trainer.init_state(_reader().get_batch("train", np.arange(2)), seed=seed)
    return trainer


def _tensors(trainer):
    """Every tensor that a load writes and a captured graph reads, by name."""
    out = {f"param {k}": v for k, v in trainer.model.state_dict().items()}
    out.update({f"packed {k}": v for k, v in trainer.state.packed.items()})
    out.update({f"acc {k}": v for k, v in getattr(trainer.state, "table_acc", {}).items()})
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for param, entry in trainer.state.optimizer.state.items():
        out.update({f"opt {names[id(param)]} {k}": v for k, v in entry.items()})
    return out


def _pointers(trainer):
    return {k: v.data_ptr() for k, v in _tensors(trainer).items()}


def _values(trainer):
    return {k: v.detach().clone() for k, v in _tensors(trainer).items()}


def _assert_equal(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def _fit(trainer, epochs, seed):
    trainer.fit(_reader(), batch_size=BATCH, epochs=epochs, verbose=0, seed=seed)
    return trainer.step_losses.clone()


@pytest.mark.parametrize("case", ["f32", "int8", "classic"])
def test_a_weights_file_names_the_jax_leaves(case, tmp_path):
    table, _ = CASES[case]
    columns = _columns(jfc)
    columns.update(sparse_columns=tuple(columns["sparse_columns"]),
                   dense_columns=tuple(columns["dense_columns"]))
    jax_model = JaxDCNv2(**columns, emb_size=E, num_cross_layers=2, layers=(8,), **FORMATS[table])
    if table == "f32":
        jax_trainer = JaxSparse(jax_model, packed_tables=True)
    else:
        jax_trainer = JaxQuantized(jax_model, packed_tables=table == "int8")
    jax_trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    jax_trainer.init_state(_reader().get_batch("train", np.arange(2)), seed=0)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(jax_trainer.state.params), sep="/").items()}
    trainer = _trainer(case)
    path = str(tmp_path / "w" / "weights.pt")
    trainer.save_weights(path)
    saved = torch.load(path, weights_only=True)
    assert set(saved) == set(flat) - UNREAD_LEAVES
    for key, value in saved.items():
        assert tuple(value.shape) == flat[key].shape and str(value.dtype).split(".")[-1] == \
            str(flat[key].dtype), key
    pointers = _pointers(trainer)
    load_leaves(flat, trainer)  # JAX's own leaves, in place
    assert _pointers(trainer) == pointers
    trainer.save_weights(path)
    for key, value in torch.load(path, weights_only=True).items():
        np.testing.assert_array_equal(value.numpy(), flat[key], err_msg=key)


@pytest.mark.parametrize("case", ["f32", "int8", "classic"])
def test_weights_round_trip_and_best_weights_in_ram(case, tmp_path):
    """``tests/test_trainer.py``'s pattern: weights to disk and to RAM, the
    weights drift, each load brings the scores back, bit for bit, into the
    same tensors."""
    reader, trainer = _reader(), _trainer(case)
    _fit(trainer, 1, seed=1)
    p1 = trainer.predict(reader, split="dev", batch_size=16)
    path = str(tmp_path / "w.pt")
    trainer.save_weights(path)
    trainer.save_best_weights()
    assert all(v.device.type == "cpu" for v in trainer.best_params.values())
    pointers = _pointers(trainer)
    step = trainer.state.step
    _fit(trainer, 1, seed=2)
    p2 = trainer.predict(reader, split="dev", batch_size=16)
    assert not np.allclose(p1, p2)
    trainer.load_weights(path)
    np.testing.assert_array_equal(trainer.predict(reader, split="dev", batch_size=16), p1)
    assert trainer.state.step == step + 4  # weights hold no step
    _fit(trainer, 1, seed=3)
    trainer.load_best_weights()
    np.testing.assert_array_equal(trainer.predict(reader, split="dev", batch_size=16), p1)
    assert _pointers(trainer) == pointers


@pytest.mark.parametrize("case", ["f32", "int8", "classic", "dropout"])
def test_resume_is_bit_equal_to_the_uninterrupted_run(case, tmp_path):
    a = _trainer(case)
    _fit(a, 2, seed=3)
    want_losses = _fit(a, 1, seed=4)

    b = _trainer(case)
    _fit(b, 2, seed=3)
    path = str(tmp_path / "ckpt" / "state.pt")
    b.save_checkpoint(path)
    assert os.listdir(tmp_path / "ckpt") == ["state.pt"]

    c = _trainer(case, seed=9)  # other weights, generator and rounding key
    _fit(c, 1, seed=9)  # its optimizer has state, its steps their layouts
    pointers = _pointers(c)
    c.restore_checkpoint(path)
    assert _pointers(c) == pointers
    assert c.state.step == b.state.step == 8
    _assert_equal(_values(c), _values(b))
    got_losses = _fit(c, 1, seed=4)
    assert torch.equal(got_losses, want_losses)
    _assert_equal(_values(c), _values(a))
    if case in ("int8", "classic"):
        assert np.array_equal(c.state.rng_key, a.state.rng_key)
        assert np.array_equal(c.state.scalars.rng_key, a.state.rng_key)
    if case == "dropout":
        assert torch.equal(c.state.rng.get_state(), a.state.rng.get_state())


def test_restore_into_a_trainer_that_never_stepped(tmp_path):
    """Without optimizer state yet, a restore creates it; a checkpoint from
    before any step zeroes the state of a trainer that has one."""
    b = _trainer("f32")
    path0, path = str(tmp_path / "0.pt"), str(tmp_path / "s.pt")
    b.save_checkpoint(path0)
    _fit(b, 1, seed=3)
    b.save_checkpoint(path)
    fresh = _trainer("f32", seed=5)
    fresh.restore_checkpoint(path)
    _assert_equal(_values(fresh), _values(b))
    pointers = _pointers(fresh)
    fresh.restore_checkpoint(path0)
    assert _pointers(fresh) == pointers and fresh.state.step == 0
    for key, value in _tensors(fresh).items():
        if key.startswith("opt"):
            assert not value.any(), key
    with pytest.raises(RuntimeError, match="init_state"):
        _trainer("f32", init=False).restore_checkpoint(path)


def test_manager_keeps_the_newest_and_writes_atomically(tmp_path):
    trainer = _trainer("int8")
    manager = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    for epoch in range(5):
        _fit(trainer, 1, seed=epoch)
        manager.save(trainer.state.step, trainer)
    saved = _values(trainer)
    manager.save(trainer.state.step + 100, trainer)  # the host copies are taken here
    _fit(trainer, 1, seed=9)  # ... so the steps after it do not reach the file
    manager.wait()
    assert manager.steps() == [16, 20, 120] and manager.latest_step() == 120
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["120.pt", "16.pt", "20.pt"]  # no .tmp
    fresh = _trainer("int8", seed=3)
    assert manager.restore(fresh) == 120
    _assert_equal(_values(fresh), saved)
    assert manager.restore(fresh, 16) == 16 and fresh.state.step == 16
    manager.close()


@pytest.mark.parametrize("async_save", [True, False])
def test_a_failed_write_raises_and_leaves_no_file(async_save, tmp_path):
    trainer = _trainer("f32")
    manager = CheckpointManager(str(tmp_path), async_save=async_save)
    trainer.checkpoint_state = lambda: {"not saved": lambda: None}  # torch.save cannot pickle it
    if async_save:
        manager.save(1, trainer)
        with pytest.raises(Exception):
            manager.wait()
    else:
        with pytest.raises(Exception):
            manager.save(1, trainer)
    assert os.listdir(tmp_path) == [] and manager.latest_step() is None
    manager.close()


def test_checkpoint_callback_and_maybe_resume(tmp_path):
    trainer = _trainer("classic")
    callback = CheckpointCallback(str(tmp_path), every_epochs=2, max_to_keep=2)
    trainer.fit(_reader(), batch_size=BATCH, epochs=5, verbose=0, callbacks=[callback])
    assert callback.ckpt.steps() == [8, 16]
    fresh = _trainer("classic", seed=7)
    resumer = CheckpointCallback(str(tmp_path))
    resumer.set_trainer(fresh)
    assert resumer.maybe_resume() == 16 and fresh.state.step == 16
    empty = CheckpointCallback(str(tmp_path / "none"))
    empty.set_trainer(fresh)
    assert empty.maybe_resume() is None


class _Sigterm(Callback):
    """Sends this process a SIGTERM after train batch ``at``."""

    def __init__(self, at):
        super().__init__()
        self.at = at

    def on_train_batch_end(self, batch, logs=None):
        if batch == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


def test_preemption_guard_saves_and_stops_on_sigterm(tmp_path):
    previous = signal.getsignal(signal.SIGTERM)
    trainer = _trainer("f32")
    guard = PreemptionGuard(str(tmp_path))
    history = trainer.fit(_reader(), batch_size=BATCH, epochs=3, verbose=0,
                          callbacks=[_Sigterm(1), guard])
    assert guard.preempted and trainer.stop_training
    assert signal.getsignal(signal.SIGTERM) is previous  # the handler window closed
    assert trainer.state.step == 2 and guard.ckpt.steps() == [2]
    assert history.epoch == [0] and "auc" not in history.history
    fresh = _trainer("f32", seed=3)
    resumer = PreemptionGuard(str(tmp_path))
    resumer.set_trainer(fresh)
    assert resumer.maybe_resume() == 2
    _assert_equal(_values(fresh), _values(trainer))
