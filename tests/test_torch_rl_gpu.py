"""The value-RL trainers on the card.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_rl_gpu.py

A small DQN (1000 items, E = hidden = 16, batch 256, 6-step states, 4 next
candidates, MSE, Adam) and an LSRL with dropout:

* the target sync cadence across captured windows: with ``update_freq=3``,
  ``fit`` with ``scan_batches=3`` and ``dev_freq=4`` runs windows of 3, 1,
  3 and 1 steps (a graph each size); at each window's end the network and
  the target equal those of eager ``train_step``s over the same batches,
  bit for bit, and the target equals the network after step 3 only (steps
  3 and 6 sync inside replays);
* fresh dropout masks on each replay: LSRL with dropout 0.5 at lr 0 (no
  value moves, so only the masks can change a loss) replays a captured step
  on one batch: the losses differ from replay to replay, and with dropout 0
  they are equal;
* B2, B3 and B4 against their plain versions on one RL step's arguments
  (the unpacked, packed and int8 tables): B2 rtol 1e-5 / atol 1e-5 of the
  largest sum, B3 and B4 bit-exact.
"""

import contextlib

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity
from pytorchrec_tpu_torch.models import DQNQNet, ValueRLModel
from pytorchrec_tpu_torch.models.rl import make_lsrl_qnet
from pytorchrec_tpu_torch.ops import quantized_packed, sparse_update
from pytorchrec_tpu_torch.ops.kernels.quantize import requantize_rows, requantize_rows_plain
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows, scatter_set_rows_plain
from pytorchrec_tpu_torch.ops.kernels.seg_scan import (
    segmented_sum_scan,
    segmented_sum_scan_plain,
)
from pytorchrec_tpu_torch.training import Callback, RLTrainer, SparseRLTrainer

pytestmark = pytest.mark.gpu

ITEMS, USERS, E, B, S, N = 1000, 200, 16, 256, 6, 4
COL = CategoricalColumnWithIdentity


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _columns():
    return dict(iid=COL(feature_name="iid", category_num=ITEMS),
                state=COL(feature_name="state", category_num=ITEMS),
                state_len=COL(feature_name="state_len", category_num=S + 1),
                next_state=COL(feature_name="next_state", category_num=ITEMS),
                next_state_len=COL(feature_name="next_state_len", category_num=S + 1),
                rl_sample=COL(feature_name="rl_sample", category_num=ITEMS),
                label=COL(feature_name="label", category_num=2))


def _dqn(update_freq=3, quantized=False):
    c = _columns()
    qnet = DQNQNet(iid_column=c["iid"], state_column=c["state"],
                   state_len_column=c["state_len"], next_state_column=c["next_state"],
                   next_state_len_column=c["next_state_len"], rl_sample_column=c["rl_sample"],
                   emb_size=E, hidden_size=E, quantized_table=quantized, device="cuda")
    return ValueRLModel(qnet, reward_column=c["label"], update_freq=update_freq)


def _lsrl(dropout):
    c = _columns()
    qnet = make_lsrl_qnet(
        iid_column=c["iid"], uid_column=COL(feature_name="uid", category_num=USERS),
        pos_state_column=c["state"], pos_state_len_column=c["state_len"],
        pos_next_state_column=c["next_state"], pos_next_state_len_column=c["next_state_len"],
        neg_state_column=COL(feature_name="neg_state", category_num=ITEMS),
        neg_state_len_column=COL(feature_name="neg_state_len", category_num=S + 1),
        neg_next_state_column=COL(feature_name="neg_next_state", category_num=ITEMS),
        neg_next_state_len_column=COL(feature_name="neg_next_state_len", category_num=S + 1),
        rl_sample_column=c["rl_sample"], emb_size=E, hidden_size=E, dropout=dropout,
        device="cuda")
    return ValueRLModel(qnet, reward_column=c["label"], update_freq=3)


def _batch(rng, rows=B):
    out = {"iid": rng.integers(0, ITEMS, rows), "uid": rng.integers(0, USERS, rows),
           "label": rng.integers(0, 2, rows)}
    for name in ("state", "next_state", "neg_state", "neg_next_state"):
        out[name] = rng.integers(0, ITEMS, (rows, S))
        out[f"{name}_len"] = rng.integers(1, S + 1, rows)
    out["rl_sample"] = rng.integers(0, ITEMS, (rows, N))
    return {k: v.astype(np.int32) for k, v in out.items()}


class _ArrayReader:
    """The batches of ``rows`` as a reader's train split (and its dev)."""

    train_mode = None

    def __init__(self, rows):
        self.rows = rows

    def get_train_dataset_size(self):
        return len(self.rows["iid"])

    def get_dataset_size(self, split):
        return len(self.rows["iid"])

    def get_batch(self, split, indices):
        return {k: v[indices] for k, v in self.rows.items()}


class _WindowEnds(Callback):
    def __init__(self, trainer):
        super().__init__()
        self.trainer, self.ends = trainer, []

    def on_epoch_end(self, epoch, logs=None):
        t = self.trainer
        self.ends.append((t.state.step, {k: v.clone() for k, v in t.model.state_dict().items()},
                          {k: v.clone() for k, v in t.state.target.state_dict().items()}))


def _trainer(model, kind):
    if kind == "dense":
        trainer = RLTrainer(model, device="cuda")
    else:
        trainer = SparseRLTrainer(model, device="cuda", packed_tables=kind == "packed")
    trainer.compile(optimizer="adam", lr=1e-2, loss="mse", metrics=())
    return trainer


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_sync_cadence_across_captured_windows(kind):
    _need_card()
    rng = np.random.default_rng(0)
    rows = _batch(rng, 8 * B)
    reader = _ArrayReader(rows)
    sample = reader.get_batch("train", np.arange(2))
    eager = _trainer(_dqn(), kind)
    eager.init_state(sample, seed=0)
    captured = _trainer(_dqn(), kind)
    captured.init_state(sample, seed=0)
    # the order fit deals the batches in: one shuffled pass from default_rng(seed)
    order = np.arange(8 * B)
    np.random.default_rng(5).shuffle(order)
    snapshots = {}
    for step in range(1, 9):
        eager.train_step(reader.get_batch("train", order[(step - 1) * B:step * B]))
        snapshots[step] = (eager.model.state_dict(), eager.state.target.state_dict())
        snapshots[step] = tuple({k: v.clone() for k, v in d.items()} for d in snapshots[step])
    ends = _WindowEnds(captured)
    captured.fit(reader, batch_size=B, epochs=8, verbose=0, dev_freq=4, seed=5,
                 eval_dev=False, scan_batches=3, callbacks=[ends])
    assert [step for step, _, _ in ends.ends] == [3, 4, 7, 8]
    for step, params, target in ends.ends:
        want_params, want_target = snapshots[step]
        for got, want in ((params, want_params), (target, want_target)):
            for key, value in want.items():
                assert torch.equal(got[key], value), (kind, step, key)
        synced = all(torch.equal(target[k], params[k]) for k in target)
        assert synced == (step == 3), (kind, step)


def test_captured_steps_draw_new_dropout_masks():
    _need_card()
    batch = _batch(np.random.default_rng(1))
    losses = {}
    for dropout in (0.5, 0.0):
        trainer = RLTrainer(_lsrl(dropout), device="cuda")
        trainer.compile(optimizer="adam", lr=0.0, loss="mse", metrics=())
        trainer.init_state(batch, seed=0)
        trainer.fit_steps((batch for _ in range(6)), steps=6, log_every=6)  # warm-up, replays
        losses[dropout] = trainer.step_losses.cpu()
    replays = losses[0.5][1:]
    assert len(set(replays.tolist())) == len(replays), replays
    assert len(set(losses[0.0].tolist())) == 1, losses[0.0]


@contextlib.contextmanager
def _recorded(calls):
    """The first call of each update kernel, its arguments copied before it."""
    swapped = []
    for module in (sparse_update, quantized_packed):
        for name in ("segmented_sum_scan", "scatter_set_rows", "requantize_rows"):
            kernel = getattr(module, name, None)
            if kernel is None:
                continue

            def record(*args, _name=name, _kernel=kernel):
                calls.setdefault(_name, [a.clone() if isinstance(a, torch.Tensor) else a
                                         for a in args])
                return _kernel(*args)

            setattr(module, name, record)
            swapped.append((module, name, kernel))
    try:
        yield calls
    finally:
        for module, name, kernel in swapped:
            setattr(module, name, kernel)


@pytest.mark.parametrize("kind", ["unpacked", "packed", "int8"])
def test_update_kernels_against_plain_on_an_rl_step(kind):
    _need_card()
    batch = _batch(np.random.default_rng(2))
    trainer = _trainer(_dqn(quantized=kind == "int8"), kind)
    trainer.init_state(batch, seed=0)
    with _recorded({}) as calls:
        trainer.train_step(batch)
    torch.cuda.synchronize()
    want = {"segmented_sum_scan", "scatter_set_rows"} | (
        {"requantize_rows"} if kind == "int8" else set())
    assert set(calls) == want
    x, heads = calls["segmented_sum_scan"][:2]
    plain = segmented_sum_scan_plain(x, heads)
    scale = float(plain.abs().max())
    torch.testing.assert_close(segmented_sum_scan(x, heads), plain, rtol=1e-5,
                               atol=1e-5 * scale)
    table, rows, ids = calls["scatter_set_rows"]
    expected = scatter_set_rows_plain(table.clone(), rows, ids)
    scatter_set_rows(table, rows, ids)
    assert torch.equal(table, expected)
    if kind == "int8":
        args = calls["requantize_rows"]
        assert torch.equal(requantize_rows(*args), requantize_rows_plain(*args))
