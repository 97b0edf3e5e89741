"""The fit loop's callbacks (``ModelCheckpoint``, ``EarlyStopping``,
``CSVLogger``, ``TerminateOnNaN``) of the port against the JAX package's, on
the CPU.

Each pair is driven with the same scripted logs, through a stand-in
trainer that records what the callbacks ask of it: the epoch where
``stop_training`` is set, the best-weights saves and loads, the files
written, the CSV's header and rows (NA-filled to ``epochs`` on an early
stop) and the batch whose loss is not finite. Then the port's ``fit`` with
all four, as ``tests/test_trainer.py`` runs the JAX trainer's, on a small
DCN-v2 (3 sparse fields of vocab 50, E=4, MLP (8,)): the stop epoch, the
best weights kept in RAM and restored in place, the CSV; and a batch with a
NaN feature stops both trainers' ``fit`` after that batch.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.data.schema import TrainMode as JaxTrainMode
from pytorchrec_tpu.models import DCNv2 as JaxDCNv2
from pytorchrec_tpu.training import callbacks as jcb
from pytorchrec_tpu.training.trainer import Trainer as JaxTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.data import TrainMode
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.training import callbacks as tcb
from pytorchrec_tpu_torch.training import Trainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, ROWS, BATCH = 50, 128, 32


class StandIn:
    """What a callback reads and calls on its trainer, recorded."""

    def __init__(self):
        self.stop_training = False
        self.calls = []

    def save_best_weights(self):
        self.calls.append("save_best")

    def load_best_weights(self):
        self.calls.append("load_best")

    def save_weights(self, filepath):
        self.calls.append(("save", os.path.basename(filepath)))


def _drive(callback, logs, epochs, batch_logs=()):
    """Run ``callback`` over epoch ``logs`` (and, before each epoch, the
    ``batch_logs``) as a fit loop would; returns (stand-in, last epoch)."""
    trainer = StandIn()
    callback.set_trainer(trainer)
    callback.set_params({"epochs": epochs, "verbose": 0})
    callback.on_train_begin()
    epoch = -1
    for epoch, epoch_logs in enumerate(logs):
        callback.on_epoch_begin(epoch)
        for b, batch in enumerate(batch_logs):
            callback.on_train_batch_begin(b)
            callback.on_train_batch_end(b, batch)
            if trainer.stop_training:
                break
        callback.on_epoch_end(epoch, epoch_logs)
        if trainer.stop_training:
            break
    callback.on_train_end()
    return trainer, epoch


AUC = [0.61, 0.64, 0.639, 0.66, 0.66, 0.70, 0.69, 0.68, 0.71, 0.70]
LOGS = [{"loss": 1.0 / (i + 1), "auc": a} for i, a in enumerate(AUC)]


@pytest.mark.parametrize("kwargs", [
    dict(monitor="auc", mode="max", patience=0),
    dict(monitor="auc", mode="max", patience=1, restore_best_weights=True),
    dict(monitor="auc", mode="max", patience=2, min_delta=0.015),
    dict(monitor="auc", mode="max", patience=1, baseline=0.65),
    dict(monitor="loss", mode="min", patience=0),
    dict(monitor="missing", mode="min", patience=0),
])
def test_early_stopping_matches_jax(kwargs):
    want, want_epoch = _drive(jcb.EarlyStopping(**kwargs), LOGS, len(LOGS))
    callback = tcb.EarlyStopping(**kwargs)
    got, got_epoch = _drive(callback, LOGS, len(LOGS))
    assert (got_epoch, got.stop_training, got.calls) == (want_epoch, want.stop_training,
                                                         want.calls)
    assert callback.stopped_epoch == (got_epoch if got.stop_training else 0)


@pytest.mark.parametrize("kwargs", [
    dict(filepath="w/best.pt", monitor="auc", mode="max"),
    dict(filepath=None, monitor="auc", mode="max"),
    dict(filepath="w/every.pt", monitor="loss", save_best_only=False),
    dict(filepath="w/batches.pt", monitor="loss", save_freq=3),
])
def test_model_checkpoint_matches_jax(kwargs, tmp_path):
    kwargs = dict(kwargs)
    if kwargs["filepath"] is not None:
        kwargs["filepath"] = str(tmp_path / kwargs["filepath"])
    batch_logs = [{"loss": 0.5 - 0.01 * b} for b in range(4)]
    want, _ = _drive(jcb.ModelCheckpoint(**kwargs), LOGS, len(LOGS), batch_logs)
    got, _ = _drive(tcb.ModelCheckpoint(**kwargs), LOGS, len(LOGS), batch_logs)
    assert got.calls == want.calls and got.calls


@pytest.mark.parametrize("stop_at", [None, 3])
def test_csv_logger_matches_jax(stop_at, tmp_path):
    texts = []
    for module, name in ((jcb, "jax.tsv"), (tcb, "port.tsv")):
        path = tmp_path / "logs" / name
        callback = module.CSVLogger(str(path))
        logs = LOGS if stop_at is None else LOGS[:stop_at + 1]
        _drive(callback, logs, len(LOGS))
        texts.append(path.read_text())
    assert texts[1] == texts[0]
    lines = texts[1].splitlines()
    assert lines[0].split("\t") == ["epoch", "auc", "loss"]
    assert len(lines) == 1 + len(LOGS)  # NA-filled to every epoch
    if stop_at is not None:
        assert lines[stop_at + 2].split("\t") == [str(stop_at + 1), "NA", "NA"]


@pytest.mark.parametrize("bad", [math.nan, math.inf, None])
def test_terminate_on_nan_matches_jax(bad):
    batch_logs = [{"loss": 0.5}, {"loss": 0.4}, {"loss": bad}, {"loss": 0.3}]
    if bad is None:
        batch_logs[2] = {}
    want, want_epoch = _drive(jcb.TerminateOnNaN(), LOGS, len(LOGS), batch_logs)
    got, got_epoch = _drive(tcb.TerminateOnNaN(), LOGS, len(LOGS), batch_logs)
    assert (got_epoch, got.stop_training) == (want_epoch, want.stop_training)
    assert got.stop_training == (bad is not None)


class ArrayReader:
    def __init__(self, splits, train_mode):
        self.splits, self.train_mode = splits, train_mode

    def get_dataset_size(self, split):
        return len(self.splits[split]["label"])

    def get_train_dataset_size(self):
        return self.get_dataset_size("train")

    def get_dev_dataset_size(self):
        return self.get_dataset_size("dev")

    def get_batch(self, split, indices):
        return {k: v[indices] for k, v in self.splits[split].items()}


def _split(rng, rows):
    split = {f"c_{i}": rng.integers(0, VOCAB, rows).astype(np.int32) for i in range(3)}
    split["d_0"] = rng.normal(size=rows).astype(np.float32)
    # a learnable label: the sign of a fixed mix of the dense value and one id
    split["label"] = (split["d_0"] + (split["c_0"] % 2) - 0.5 > 0).astype(np.int32)
    return split


def _kwargs(fc):
    return dict(sparse_columns=[fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                                 category_num=VOCAB)
                                for i in range(3)],
                dense_columns=[fc.NumericColumn(feature_name="d_0")],
                label_column=fc.CategoricalColumnWithIdentity(feature_name="label",
                                                              category_num=2),
                emb_size=4, num_cross_layers=1, layers=(8,))


def _pair(splits):
    """The JAX trainer and the port's from one state (JAX's init)."""
    kwargs = _kwargs(jfc)
    kwargs.update(sparse_columns=tuple(kwargs["sparse_columns"]),
                  dense_columns=tuple(kwargs["dense_columns"]))
    jax_trainer = JaxTrainer(JaxDCNv2(**kwargs))
    compiled = dict(optimizer="adam", lr=5e-2, loss="bce", metrics=("auc",))
    jax_trainer.compile(**compiled)
    jax_trainer.init_state({k: v[:2] for k, v in splits["train"].items()}, seed=0)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(jax_trainer.state.params), sep="/").items()}
    port = Trainer(DCNv2(**_kwargs(tfc), device="cpu",
                         generator=torch.Generator().manual_seed(0)), device="cpu")
    port.compile(**compiled)
    port.init_state({k: v[:2] for k, v in splits["train"].items()}, seed=0)
    params_from_jax(flat, port.model)
    return jax_trainer, port


def _splits(nan_row=None):
    rng = np.random.default_rng(2)
    splits = {"train": _split(rng, ROWS), "dev": _split(rng, 64)}
    if nan_row is not None:
        splits["train"]["d_0"][nan_row] = np.nan
    return splits


def test_fit_with_the_four_callbacks(tmp_path):
    """``tests/test_trainer.py``'s callback run on the port: an early stop
    on the dev AUC, the best weights kept in RAM (``ModelCheckpoint(None)``)
    and restored in place, the CSV NA-filled to ``epochs`` rows."""
    splits = _splits()
    _, port = _pair(splits)
    reader = ArrayReader(splits, TrainMode.POINT_WISE)
    scores = {}

    class Scores(tcb.Callback):
        def on_epoch_end(self, epoch, logs=None):
            scores[epoch] = port.predict(reader, split="dev", batch_size=BATCH)

    csv_path = str(tmp_path / "log.tsv")
    pointers = {k: v.data_ptr() for k, v in port.model.state_dict().items()}
    history = port.fit(reader, batch_size=BATCH, epochs=30, verbose=0, callbacks=[
        Scores(), tcb.EarlyStopping(monitor="auc", mode="max", patience=1,
                                    restore_best_weights=True),
        tcb.ModelCheckpoint(None, monitor="auc", mode="max"), tcb.CSVLogger(csv_path),
        tcb.TerminateOnNaN()])
    auc = history.history["auc"]
    stop = len(auc) - 1  # patience 1: the first epoch that does not improve
    assert port.stop_training and 1 <= stop < 29
    assert all(auc[i] > auc[i - 1] for i in range(1, stop)) and auc[stop] <= auc[stop - 1]
    best = stop - 1
    assert history.get_best_epoch_logs("auc", mode="max")[0] == best
    assert port.best_params is not None
    assert all(v.device.type == "cpu" for v in port.best_params.values())
    # the best epoch's weights, back in the same tensors
    np.testing.assert_array_equal(port.predict(reader, split="dev", batch_size=BATCH),
                                  scores[best])
    assert {k: v.data_ptr() for k, v in port.model.state_dict().items()} == pointers
    with open(csv_path) as f:
        lines = f.read().strip().split("\n")
    assert lines[0] == "epoch\tauc\tloss" and len(lines) == 30 + 1
    assert lines[stop + 2] == f"{stop + 1}\tNA\tNA"


def test_a_nan_batch_stops_fit_as_in_jax():
    """A NaN dense value in the third batch (no shuffle): both trainers stop
    after that batch, its loss NaN, in the first epoch."""
    splits = _splits(nan_row=2 * BATCH + 5)
    jax_trainer, port = _pair(splits)
    histories = []
    for trainer, mode in ((jax_trainer, JaxTrainMode.POINT_WISE),
                          (port, TrainMode.POINT_WISE)):
        module = jcb if trainer is jax_trainer else tcb
        histories.append(trainer.fit(ArrayReader(splits, mode), batch_size=BATCH, epochs=3,
                                     verbose=0, shuffle=False,
                                     callbacks=[module.TerminateOnNaN()]))
        assert trainer.stop_training
    want, got = histories
    assert got.epoch == want.epoch == [0]
    assert math.isnan(got.history["loss"][0]) and math.isnan(want.history["loss"][0])
    assert "auc" not in got.history and "auc" not in want.history
    assert port.state.step == int(jax_trainer.state.step) == 3
