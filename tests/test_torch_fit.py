"""The port's ``Trainer.fit`` (and ``fit_steps(callbacks=...)``) against the
JAX trainer's, on the CPU.

A reader over seeded numpy columns serves both trainers (``ArrayReader``,
as in ``tests/test_torch_evaluate.py``, with ``train_mode`` and
``train_neg_sample``). Two models, each initialised in JAX and loaded into
the port with ``params_from_jax``:

* a small DCN-v2 (3 sparse fields of vocab 50, E=8, 2 dense fields, 2
  cross layers, MLP (8,)) under the packed f32 sparse trainer, point-wise
  BCE at lr 1e-2 on Zipf-drawn ids (as ``tests/test_torch_fit_steps_*``),
  200 train rows in batches of 64, dev AUC and logloss over 70 rows;
* a small DIN (E=8, attention (16, 8), MLP (16, 8)) under the packed f32
  sparse trainer, pair-wise (``[B, 2]`` candidates, the positive first,
  the negative drawn anew by ``train_neg_sample`` each epoch) under BPR,
  dev NDCG and Hit over leave-one-out rows of 10 candidates.

Both start from leaves that spread the scores out (kernels N(0, 2 /
fan_in), table columns N(0, 0.5); the packed moment columns stay zero):
gradients stay out of Adam's eps window, and no two dev predictions that
a metric ranks against each other (DCN-v2's for AUC, a DIN row's
candidates) lie within 1e-4, so no rank can flip between the frameworks
(checked on JAX's last predictions).

Against JAX the epochs drop the short last batch: with ``drop_last=False``
the JAX trainer's prefetch thread rebuilds its one packer when the short
batch is packed, while the full batches before it are still to be unpacked
with the old one, so JAX's own losses of those batches are wrong (negative
BCE). The port keeps a packer a layout; its short batches are held to the
eager step instead (``test_fit_is_a_train_step_loop``).

Tolerances: epoch losses and dev metrics rtol 1e-4 (f32 sums in another
order, compounded over the epochs' steps); the history's keys, epochs and
the callbacks' hooks exactly. On the CPU ``fit`` runs the captured step's
body eagerly over its static inputs, so it is bit-equal to a loop of
``train_step`` over the same shuffled batches.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.data.schema import TrainMode as JaxTrainMode
from pytorchrec_tpu.models import DCNv2 as JaxDCNv2
from pytorchrec_tpu.models.din import DIN as JaxDIN
from pytorchrec_tpu.training import callbacks as jax_callbacks
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer as JaxQuantized
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer as JaxSparse
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.data import TrainMode, train_batches
from pytorchrec_tpu_torch.models import DCNv2, DIN
from pytorchrec_tpu_torch.training import (
    Callback,
    QuantizedEmbeddingTrainer,
    SparseEmbeddingTrainer,
)
from pytorchrec_tpu_torch.training import callbacks as port_callbacks
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, E, LR = 50, 3, 2, 8, 1e-2
USERS, ITEMS, S, N = 40, 300, 5, 10
DCN_TRAIN, DCN_DEV, DCN_BATCH = 200, 70, 64
DIN_TRAIN, DIN_DEV, DIN_BATCH = 96, 21, 32
RTOL, MIN_GAP = 1e-4, 1e-4
FORMATS = {"f32": dict(unified_embedding=True),
           "int8": dict(unified_embedding=True, quantized_embedding=True, table_packed=True),
           "classic": dict(unified_embedding=True, quantized_embedding=True)}


class ArrayReader:
    """Columns of numpy arrays by split; a batch is a row selection. Under
    ``PAIR_WISE``, ``train_neg_sample`` draws each train row's negative
    (``iid[:, 1]``) from a generator seeded by its call count, so two
    readers made alike draw alike."""

    def __init__(self, splits, train_mode):
        self.splits = {name: dict(split) for name, split in splits.items()}
        self.train_mode = train_mode
        self.neg_samples = 0

    def get_dataset_size(self, split):
        return len(next(iter(self.splits[split].values())))

    def get_train_dataset_size(self):
        return self.get_dataset_size("train")

    def get_dev_dataset_size(self):
        return self.get_dataset_size("dev")

    def get_batch(self, split, indices):
        return {k: v[indices] for k, v in self.splits[split].items()}

    def train_neg_sample(self):
        self.neg_samples += 1
        iid = self.splits["train"]["iid"].copy()
        rng = np.random.default_rng(1000 + self.neg_samples)
        iid[:, 1] = rng.integers(1, ITEMS, size=len(iid))
        self.splits["train"]["iid"] = iid


def _dcn_split(rng, rows):
    split = {f"c_{i}": np.minimum(rng.zipf(1.5, rows) - 1, VOCAB - 1).astype(np.int64)
             for i in range(N_SPARSE)}
    split.update({f"d_{i}": rng.normal(size=rows).astype(np.float32) for i in range(N_DENSE)})
    split["label"] = rng.integers(0, 2, rows).astype(np.int32)
    return split


def _din_split(rng, rows, candidates):
    lengths = rng.integers(0, S + 1, size=rows).astype(np.int32)
    his = rng.integers(1, ITEMS, size=(rows, S)).astype(np.int32)
    his[np.arange(S)[None, :] >= lengths[:, None]] = 0
    split = {"uid": rng.integers(0, USERS, size=rows).astype(np.int32),
             "iid": np.stack([rng.choice(np.arange(1, ITEMS), candidates, replace=False)
                              for _ in range(rows)]).astype(np.int32),
             "pos_his": his, "pos_his_len": lengths}
    if candidates == 2:
        split["label"] = np.ones(rows, dtype=np.int32)
    return split


def _dcn_kwargs(fc, table):
    return dict(sparse_columns=[fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                                 category_num=VOCAB)
                                for i in range(N_SPARSE)],
                dense_columns=[fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
                label_column=fc.CategoricalColumnWithIdentity(feature_name="label",
                                                              category_num=2),
                emb_size=E, num_cross_layers=2, layers=(8,), **FORMATS[table])


def _din_kwargs(fc):
    col = fc.CategoricalColumnWithIdentity
    return dict(uid_column=col(feature_name="uid", category_num=USERS),
                iid_column=col(feature_name="iid", category_num=ITEMS),
                his_column=col(feature_name="pos_his", category_num=ITEMS),
                his_len_column=col(feature_name="pos_his_len", category_num=S + 1),
                label_column=col(feature_name="label", category_num=2),
                emb_size=E, att_hidden_units=(16, 8), mlp_layers=(16, 8))


def _port_model(name, table="f32", **kwargs):
    if name == "din":
        return DIN(**_din_kwargs(tfc), **kwargs, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return DCNv2(**_dcn_kwargs(tfc, table), **kwargs, device="cpu",
                 generator=torch.Generator().manual_seed(0))


def _jax_model(name, table="f32"):
    if name == "din":
        return JaxDIN(**_din_kwargs(jfc))
    kwargs = _dcn_kwargs(jfc, table)
    return JaxDCNv2(**{**kwargs, "sparse_columns": tuple(kwargs["sparse_columns"]),
                       "dense_columns": tuple(kwargs["dense_columns"])})


CASES = {
    "dcnv2": dict(loss="bce", metrics=("auc", "logloss"), batch=DCN_BATCH, epochs=3,
                  drop_last=True, mode=TrainMode.POINT_WISE),
    "din": dict(loss="bpr", metrics=("ndcg@3", "hit@3", "ndcg@10"), batch=DIN_BATCH, epochs=2,
                drop_last=True, mode=TrainMode.PAIR_WISE),
}


def _splits(name):
    rng = np.random.default_rng(5)
    if name == "din":
        return {"train": _din_split(rng, DIN_TRAIN, 2), "dev": _din_split(rng, DIN_DEV, N)}
    return {"train": _dcn_split(rng, DCN_TRAIN), "dev": _dcn_split(rng, DCN_DEV)}


def _readers(name):
    """The port's reader and JAX's: the same columns, the same modes."""
    splits = _splits(name)
    mode = CASES[name]["mode"]
    return ArrayReader(splits, mode), ArrayReader(splits, JaxTrainMode(mode.value))


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _spread(flat, seed=7):
    """Kernels N(0, 2 / fan_in), each table's first E columns N(0, 0.5)
    (a packed leaf's moment and staging columns stay as they are); biases
    and scales as the init left them."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, value in flat.items():
        leaf = path.split("/")[-1]
        if leaf == "embedding":
            value = value.copy()
            value[:, :E] = rng.normal(0.0, 0.5, size=(value.shape[0], E))
        elif value.dtype == np.float32 and value.ndim >= 2 and leaf not in (
                "bs", "dense_factors") and not re.fullmatch(r"b\d+", leaf):
            value = (rng.standard_normal(value.shape) * np.sqrt(2.0 / value.shape[-2])
                     ).astype(np.float32)
        out[path] = value
    return out


def _trainers(name, table="f32", jax_too=True, **model_kwargs):
    """(JAX trainer or None, port trainer) from one spread state."""
    case = CASES[name]
    sample = _readers(name)[1].get_batch("train", np.arange(2))
    if table == "f32":
        jax_trainer = JaxSparse(_jax_model(name, table), packed_tables=True)
    else:
        jax_trainer = JaxQuantized(_jax_model(name, table), packed_tables=table == "int8")
    compiled = dict(optimizer="adam", lr=LR, loss=case["loss"], metrics=case["metrics"],
                    user_sample_n=N)
    jax_trainer.compile(**compiled)
    jax_trainer.init_state(sample, seed=0)
    flat = _spread(_flat(jax_trainer.state.params))
    jax_trainer.state = jax_trainer.state.replace(params=traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}))
    if table == "f32":
        port = SparseEmbeddingTrainer(_port_model(name, table, **model_kwargs), device="cpu",
                                      packed_tables=True)
    else:
        port = QuantizedEmbeddingTrainer(_port_model(name, table, **model_kwargs), device="cpu",
                                         packed_tables=table == "int8")
    port.compile(**compiled)
    port.init_state(sample, seed=0)
    params_from_jax(flat, port)
    return (jax_trainer if jax_too else None), port


def _recorder(base):
    """A callback of ``base``'s framework that records every hook it sees."""

    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.calls = []

        def _add(self, *call):
            self.calls.append(call)

        def on_train_begin(self, logs=None):
            self._add("train_begin")

        def on_train_end(self, logs=None):
            self._add("train_end")

        def on_epoch_begin(self, epoch, logs=None):
            self._add("epoch_begin", epoch)

        def on_epoch_end(self, epoch, logs=None):
            self._add("epoch_end", epoch, dict(logs or {}))

        def on_train_batch_begin(self, batch, logs=None):
            self._add("batch_begin", batch)

        def on_train_batch_end(self, batch, logs=None):
            self._add("batch_end", batch, dict(logs or {}))

        def on_test_begin(self, logs=None):
            self._add("test_begin")

        def on_test_batch_begin(self, batch, logs=None):
            self._add("test_batch_begin", batch)

        def on_test_end(self, logs=None):
            self._add("test_end", dict(logs or {}))

    return Recorder()


def _stopper(base, epoch, batch):
    """Sets ``stop_training`` at train batch ``batch`` of epoch ``epoch``."""

    class Stopper(base):
        def __init__(self):
            super().__init__()
            self.epoch = -1

        def on_epoch_begin(self, e, logs=None):
            self.epoch = e

        def on_train_batch_end(self, b, logs=None):
            if (self.epoch, b) == (epoch, batch):
                self.trainer.stop_training = True

    return Stopper()


def _assert_calls_match(got, want):
    assert [c[:2] if len(c) > 1 and isinstance(c[1], int) else c[:1] for c in got] == \
        [c[:2] if len(c) > 1 and isinstance(c[1], int) else c[:1] for c in want]
    for g, w in zip(got, want):
        if isinstance(w[-1], dict):
            assert list(g[-1]) == list(w[-1]), (g, w)
            for key, value in w[-1].items():
                np.testing.assert_allclose(g[-1][key], value, rtol=RTOL, err_msg=str(w))


def _min_gap(predictions):
    """The least distance between two predictions a metric ranks against
    each other: any two of ``[B]`` scores, two candidates of a ``[B, N]`` row."""
    predictions = np.asarray(predictions, dtype=np.float64)
    rows = np.sort(predictions if predictions.ndim == 2 else predictions[None], axis=-1)
    return np.diff(rows, axis=-1).min()


@pytest.mark.parametrize("name", ["dcnv2", "din"])
def test_fit_matches_jax(name):
    case = CASES[name]
    jax_trainer, port = _trainers(name)
    port_reader, jax_reader = _readers(name)
    fit = dict(batch_size=case["batch"], epochs=case["epochs"], verbose=0, seed=3,
               drop_last=case["drop_last"])
    want_calls = _recorder(jax_callbacks.Callback)
    got_calls = _recorder(Callback)
    want = jax_trainer.fit(jax_reader, callbacks=[want_calls], **fit)
    got = port.fit(port_reader, callbacks=[got_calls], **fit)
    assert got.epoch == want.epoch == list(range(case["epochs"]))
    assert list(got.history) == list(want.history) == ["loss", *case["metrics"]]
    for key, values in want.history.items():
        np.testing.assert_allclose(got.history[key], values, rtol=RTOL, err_msg=key)
    _assert_calls_match(got_calls.calls, want_calls.calls)
    steps = port.state.step
    assert steps == int(jax_trainer.state.step) == len(port.step_losses)
    if name == "din":
        assert port_reader.neg_samples == jax_reader.neg_samples == case["epochs"]
    else:  # three batches of 64 each epoch
        assert steps == 3 * case["epochs"]
    dev = np.asarray(jax_trainer.predict(jax_reader, split="dev", batch_size=case["batch"],
                                         verbose=0))
    assert _min_gap(dev) > MIN_GAP
    np.testing.assert_allclose(port.predict(port_reader, split="dev", batch_size=case["batch"]),
                               dev, rtol=RTOL, atol=1e-5)


def _state(trainer):
    out = {f"param {k}": v.clone() for k, v in trainer.model.state_dict().items()}
    out.update({f"packed {k}": v.clone() for k, v in trainer.state.packed.items()})
    out.update({f"acc {k}": v.clone() for k, v in getattr(trainer.state, "table_acc", {}).items()})
    for param, entry in trainer.state.optimizer.state.items():
        out.update({f"opt {param.shape} {k}": v.clone() for k, v in entry.items()})
    return out


@pytest.mark.parametrize("table", ["f32", "int8", "classic"])
def test_fit_is_a_train_step_loop(table):
    """Every step's loss and the whole state, bit for bit: ``fit`` with the
    dev evaluation between epochs against ``train_step`` over the batches
    that ``train_batches`` deals from ``default_rng(seed)``, the short last
    batch included."""
    reader = _readers("dcnv2")[0]
    fitted = _trainers("dcnv2", table, jax_too=False)[1]
    eager = _trainers("dcnv2", table, jax_too=False)[1]
    fitted.fit(reader, batch_size=DCN_BATCH, epochs=2, verbose=0, seed=3, drop_last=False)
    rng = np.random.default_rng(3)
    losses = [eager.train_step(batch) for _ in range(2)
              for batch in train_batches(reader, DCN_BATCH, rng, True, False)]
    assert len(losses) == 8
    assert torch.equal(fitted.step_losses, torch.stack(losses))
    want = _state(eager)
    got = _state(fitted)
    assert list(got) == list(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_drop_last_false_trains_the_short_batch_in_its_own_layout():
    """200 rows in batches of 64: three full batches and one of 8 an epoch,
    each layout with its own static inputs, kept across epochs (on the card
    the second epoch only replays)."""
    reader = _readers("dcnv2")[0]
    port = _trainers("dcnv2", jax_too=False)[1]
    history = port.fit(reader, batch_size=DCN_BATCH, epochs=2, verbose=0, drop_last=False,
                       eval_dev=False)
    assert port.state.step == 8 and len(history.history["loss"]) == 2
    assert len(port._layouts) == 2
    rows = sorted(layout.inputs.batch_of(0)["label"].shape[0]
                  for layout in port._layouts.values())
    assert rows == [8, DCN_BATCH]
    port.fit(reader, batch_size=DCN_BATCH, epochs=1, verbose=0, drop_last=True, eval_dev=False)
    assert port.state.step == 11 and len(port._layouts) == 2


def test_pair_wise_draws_negatives_once_an_epoch():
    port_reader, _ = _readers("din")
    port = _trainers("din", jax_too=False)[1]
    port.fit(port_reader, batch_size=DIN_BATCH, epochs=3, verbose=0, eval_dev=False)
    assert port_reader.neg_samples == 3
    port.fit(port_reader, batch_size=DIN_BATCH, epochs=2, verbose=0, eval_dev=False,
             train_mode=TrainMode.POINT_WISE)  # the argument overrides the reader's mode
    assert port_reader.neg_samples == 3


def test_stop_training_ends_the_epoch():
    """A batch hook that sets ``stop_training`` ends the epoch after its
    batch: no dev evaluation, the epoch logged with that batch's loss, as
    the JAX trainer does."""
    jax_trainer, port = _trainers("dcnv2")
    port_reader, jax_reader = _readers("dcnv2")
    fit = dict(batch_size=DCN_BATCH, epochs=3, verbose=0, seed=3)
    want_calls, got_calls = _recorder(jax_callbacks.Callback), _recorder(Callback)
    want = jax_trainer.fit(jax_reader, callbacks=[want_calls, _stopper(jax_callbacks.Callback,
                                                                         1, 1)], **fit)
    got = port.fit(port_reader, callbacks=[got_calls, _stopper(Callback, 1, 1)], **fit)
    _assert_calls_match(got_calls.calls, want_calls.calls)
    assert port.stop_training and port.state.step == 3 + 2
    assert got.epoch == want.epoch == [0, 1]
    assert list(got.history) == ["loss", "auc", "logloss"]
    assert len(got.history["loss"]) == 2 and len(got.history["auc"]) == 1
    assert got.history["loss"][1] == float(port.step_losses[-1])


@pytest.mark.parametrize("k,stop", [(1, None), (1, 4), (3, None)])
def test_fit_steps_callbacks_see_the_jax_hooks(k, stop):
    """``fit_steps(callbacks=...)`` over 7 batches, ``log_every=3``: with one
    step a call the batch hooks and a stop after batch 4 (in the second
    window), with 3 only the
    windows' ends, each hook as the JAX trainer calls it."""
    jax_trainer, port = _trainers("dcnv2")
    reader = _readers("dcnv2")[0]
    batches = [batch for seed in range(3)
               for batch in train_batches(reader, DCN_BATCH, np.random.default_rng(seed))][:7]

    def callbacks(base):
        recorder = _recorder(base)
        return recorder, [recorder] + ([] if stop is None else [_stopper(base, 1, stop)])

    want_calls, want_list = callbacks(jax_callbacks.Callback)
    got_calls, got_list = callbacks(Callback)
    jax_trainer.fit_steps(iter(batches), steps=7, log_every=3, steps_per_call=k,
                          callbacks=want_list, verbose=0)
    port.fit_steps(iter(batches), steps=7, log_every=3, steps_per_call=k, callbacks=got_list)
    _assert_calls_match(got_calls.calls, want_calls.calls)
    assert port.state.step == int(jax_trainer.state.step) == (7 if stop is None else stop + 1)
    assert any(c[0] == "batch_begin" for c in got_calls.calls) == (k == 1)


def test_no_batch_hooks_no_batch_calls():
    """Without a callback that has train-batch hooks, ``fit`` calls none
    (on the card: no host sync until the epoch's end). A ``ProgbarLogger``
    at verbose 2 and an epoch-wise ``ModelCheckpoint`` have none;
    ``TerminateOnNaN``, a batch-wise ``ModelCheckpoint`` and a verbose-1
    progress bar have them."""
    reader = _readers("dcnv2")[0]
    port = _trainers("dcnv2", jax_too=False)[1]

    class Counting(port_callbacks.CallbackList):
        batch_calls = 0

        def on_train_batch_begin(self, batch, logs=None):
            self.batch_calls += 1

        def on_train_batch_end(self, batch, logs=None):
            self.batch_calls += 1

    quiet = Counting([port_callbacks.ProgbarLogger(verbose=2), port_callbacks.ModelCheckpoint(
        None)], add_history=True, trainer=port, epochs=1, batches=4)
    port.fit(reader, batch_size=DCN_BATCH, epochs=1, callbacks=quiet, drop_last=False)
    assert quiet.batch_calls == 0 and port.state.step == 4 and port.best_params is not None
    for callback in (port_callbacks.TerminateOnNaN(), port_callbacks.ProgbarLogger(verbose=1),
                     port_callbacks.ModelCheckpoint(None, save_freq=2)):
        listed = Counting([callback], add_history=True, trainer=port, epochs=1, batches=4)
        port.fit(reader, batch_size=DCN_BATCH, epochs=1, callbacks=listed, drop_last=False)
        assert listed.batch_calls == 2 * 4, callback
