"""The fit loop on the card: ``Trainer.fit`` through the captured step and
the captured scorer, and loads into a trainer whose steps and scorer are
captured already.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_fit_gpu.py

A small DCN-v2 (3 sparse fields of vocab 1000, E=8, 2 dense fields, 2 cross
layers, MLP (16,)) over 600 train rows in batches of 128 (the last of 88
with ``drop_last=False``) and 200 dev rows. The captured graphs read and
write the tensors whose addresses they found at capture, so a load must
copy into those tensors: after captured steps, a restore followed by a
replay must equal an eager step from the restored state, bit for bit, with
dropout too (the dropout generator is registered with each graph: a
restore sets its state in place, and the replays must draw from it).
"""

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.data import TrainMode, train_batches
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.training import (
    Callback,
    QuantizedEmbeddingTrainer,
    SparseEmbeddingTrainer,
)

VOCAB, N_SPARSE, N_DENSE, E, BATCH = 1000, 3, 2, 8, 128
FORMATS = {"f32": dict(unified_embedding=True),
           "int8": dict(unified_embedding=True, quantized_embedding=True, table_packed=True),
           "classic": dict(unified_embedding=True, quantized_embedding=True)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


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
    split = {f"c_{i}": np.minimum(rng.zipf(1.3, rows) - 1, VOCAB - 1).astype(np.int64)
             for i in range(N_SPARSE)}
    split.update({f"d_{i}": rng.normal(size=rows).astype(np.float32) for i in range(N_DENSE)})
    split["label"] = rng.integers(0, 2, rows).astype(np.int32)
    return split


def _reader():
    rng = np.random.default_rng(0)
    return ArrayReader({"train": _split(rng, 600), "dev": _split(rng, 200)})


def _trainer(table="f32", dropout=0.0, seed=0):
    model = DCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        emb_size=E, num_cross_layers=2, layers=(16,), dropout=dropout, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed), **FORMATS[table])
    if table == "f32":
        trainer = SparseEmbeddingTrainer(model, packed_tables=True)
    else:
        trainer = QuantizedEmbeddingTrainer(model, packed_tables=table == "int8")
    trainer.compile(optimizer="adam", lr=1e-2, loss="bce", metrics=("auc", "logloss"))
    trainer.init_state(_reader().get_batch("train", np.arange(2)), seed=seed)
    return trainer


def _state(trainer):
    out = {f"param {k}": v.detach().clone() for k, v in trainer.model.state_dict().items()}
    out.update({f"packed {k}": v.clone() for k, v in trainer.state.packed.items()})
    out.update({f"acc {k}": v.clone()
                for k, v in getattr(trainer.state, "table_acc", {}).items()})
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for param, entry in trainer.state.optimizer.state.items():
        out.update({f"opt {names[id(param)]} {k}": v.clone() for k, v in entry.items()})
    return out


def _assert_same(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


class _Graphs(Callback):
    """At each epoch's end: the trainer's step graphs by layout, and the
    scorer's graph count."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def on_epoch_end(self, epoch, logs=None):
        self.seen.append(({key: {n: g.graph for n, g in layout.graphs.items()}
                           for key, layout in self.trainer._layouts.items()},
                          self.trainer._scores.graphs()))


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["f32", "int8", "classic"])
def test_fit_runs_the_captured_step(table):
    """Two epochs of ``fit`` (dev metrics after each) against ``fit_steps``
    over the same shuffled batches from the same state: every loss and the
    whole state bit-equal. The first epoch warms up and captures each
    layout (4 batches of 128, 1 of 88); the second captures nothing, and
    the dev scorer keeps its graph."""
    _need_card()
    reader = _reader()
    fitted, stepped = _trainer(table), _trainer(table)
    graphs = _Graphs()
    before = cross_network.launches
    fitted.fit(reader, batch_size=BATCH, epochs=2, verbose=0, seed=3, drop_last=False,
               callbacks=[graphs])
    (first, scorer), (second, scorer_again) = graphs.seen
    assert len(first) == 2 and all(list(g) == [1] for g in first.values())
    assert second == first and scorer_again == scorer == 1
    assert cross_network.launches - before > 0
    rng = np.random.default_rng(3)
    batches = [b for _ in range(2) for b in train_batches(reader, BATCH, rng, True, False)]
    stepped.fit_steps(iter(batches), steps=10, log_every=5)
    assert torch.equal(fitted.step_losses, stepped.step_losses)
    _assert_same(_state(fitted), _state(stepped))


@pytest.mark.gpu
@pytest.mark.parametrize("table,dropout", [("f32", 0.0), ("int8", 0.0), ("classic", 0.0),
                                           ("f32", 0.5)])
def test_a_restore_after_capture_then_a_replay_is_an_eager_step(table, dropout, tmp_path):
    """After captured steps, ``restore_checkpoint`` of an earlier state, then
    one replay, against an eager ``train_step`` from the same restored state
    (and generator): the loss and the whole state bit-equal."""
    _need_card()
    reader = _reader()
    captured = _trainer(table, dropout)
    captured.fit(reader, batch_size=BATCH, epochs=1, verbose=0, seed=1, eval_dev=False)
    path = str(tmp_path / "early.pt")
    captured.save_checkpoint(path)
    captured.fit(reader, batch_size=BATCH, epochs=1, verbose=0, seed=2, eval_dev=False)
    assert captured._graphs  # the layout's steps are captured
    captured.restore_checkpoint(path)
    eager = _trainer(table, dropout, seed=5)
    eager.restore_checkpoint(path)
    batch = reader.get_batch("train", np.arange(BATCH))
    captured.fit_steps(iter([batch]), steps=1, log_every=1)  # a replay of the 1-step graph
    loss = eager.train_step(batch)
    assert torch.equal(captured.step_losses[0], loss)
    _assert_same(_state(captured), _state(eager))
    if dropout:
        captured.fit_steps(iter([batch, batch]), steps=2, log_every=2)
        losses = torch.stack([eager.train_step(batch) for _ in range(2)])
        assert torch.equal(captured.step_losses, losses) and losses[0] != losses[1]


@pytest.mark.gpu
def test_load_weights_after_capture_serves_the_loaded_weights(tmp_path):
    """``load_weights`` into a trainer whose steps and scorer are captured:
    the captured scorer then returns what it returned when the file was
    written, and ``serve.eager`` agrees, bit for bit."""
    _need_card()
    reader = _reader()
    trainer = _trainer("int8")
    request = {k: v for k, v in reader.get_batch("dev", np.arange(64)).items() if k != "label"}
    serve = trainer.make_serving_fn()
    trainer.fit(reader, batch_size=BATCH, epochs=1, verbose=0, eval_dev=False)
    serve(request)
    written = serve(request)  # a replay
    path = str(tmp_path / "w.pt")
    trainer.save_weights(path)
    trainer.fit(reader, batch_size=BATCH, epochs=1, verbose=0, seed=7, eval_dev=False)
    assert not torch.equal(serve(request), written)
    pointers = {k: v.data_ptr() for k, v in trainer.model.state_dict().items()}
    trainer.load_weights(path)
    assert {k: v.data_ptr() for k, v in trainer.model.state_dict().items()} == pointers
    assert torch.equal(serve(request), written)
    assert torch.equal(serve.eager(request), written)
