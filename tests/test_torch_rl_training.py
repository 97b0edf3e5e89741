"""The value-RL trainers of the port against the JAX package's, on the CPU.

The networks, readers and scaled leaves of ``tests/test_torch_rl_models.py``
(DQN and LSRL, E = hidden = 8, dropout 0) train under the MSE loss against
the Bellman target, Adam at lr 1e-2, ``update_freq=3``, on the reader's
16-row train batches, under four trainers:

* ``RLTrainer``: dense Adam over every parameter, the tables included;
* ``SparseRLTrainer``: the tables (DQN's item table; LSRL's item and user
  tables) unpacked under lazy Adam, their moments in the state;
* ``SparseRLTrainer(packed_tables=True)``: the tables as packed
  ``table || m || v || staging`` f32 rows;
* ``SparseRLTrainer`` on ``quantized_table=True``: the int8 ``i_q`` under
  rowwise Adagrad and id-keyed stochastic requantization (LSRL's user table
  unpacked under lazy Adam beside it).

Before each of 6 steps the port takes JAX's whole state (the params and the
target params, optax's Adam moments and count, the table moments, the
step), as ``tests/test_torch_fit_steps_stepped.py`` does, and both take the
step on the same batch: the loss rtol 1e-5; every Adam-moved value outside
Adam's eps window rtol 1e-4 / atol 1e-6 (inside it within one step of lr),
the moments rtol 1e-4 with atols that hold the gradient to 1e-7; the int8
rows' q bytes exact at the ids gathered once in the step (a repeated id's
gradient is a sum, whose order differs), the others' q within one, every
touched row's f32 scale and accumulator rtol 1e-4 (their last bits carry
the gradients' f32 rounding, so the rows' bytes are not all equal), the
untouched rows bit for bit; the target network equal to the params bit for
bit after steps 3 and 6 and unchanged after the others.

Then the port alone: the sync cadence over free eager steps for each
trainer, and ``fit`` with ``scan_batches`` 1, 4 and 3 (ragged windows of 3,
1, 3, 1 with ``dev_freq=4``) bit-equal to each other and, for the dense and
the packed trainers, to JAX's ``fit`` from the same leaves (the epoch
losses and dev NDCG@5 rtol 1e-4).
"""

import jax
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from test_torch_rl_models import (
    E,
    as_tree,
    flat,
    jax_model,
    port_model,
    readers,  # noqa: F401 (the fixture)
    to_torch,
)
from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu.training import RLTrainer as JaxRLTrainer
from pytorchrec_tpu.training.rl_trainer import SparseRLTrainer as JaxSparseRLTrainer
from pytorchrec_tpu_torch.training import RLTrainer, SparseRLTrainer
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import load_leaves

LR, STEPS, UPDATE_FREQ, BATCH = 1e-2, 6, 3, 16
ADAM_B2, EPS_WINDOW = 0.999, 1e-6
RTOL, ATOL = 1e-4, 1e-6
GRAD_ATOL = 1e-7
M_ATOL, SQRT_V_ATOL = 0.1 * GRAD_ATOL, (1 - ADAM_B2) ** 0.5 * GRAD_ATOL
KINDS = {  # kind -> (model keywords, JAX trainer, port trainer)
    "dense": ({}, JaxRLTrainer, lambda m: RLTrainer(m, device="cpu")),
    "unpacked": ({}, JaxSparseRLTrainer, lambda m: SparseRLTrainer(m, device="cpu")),
    "packed": ({}, lambda m: JaxSparseRLTrainer(m, packed_tables=True),
               lambda m: SparseRLTrainer(m, device="cpu", packed_tables=True)),
    "int8": ({"quantized_table": True}, JaxSparseRLTrainer,
             lambda m: SparseRLTrainer(m, device="cpu")),
}
TABLES = {"dqn": ["i_embedding/embedding"],
          "lsrl": ["i_embeddings/embedding", "u_embeddings/embedding"]}


def train_batches(reader, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    size = reader.get_train_dataset_size()
    return [reader.get_batch("train", rng.choice(size, BATCH, replace=False)) for _ in range(n)]


def make_pair(name, kind, readers, batch):
    """The JAX trainer (scaled leaves, target = params) and the port's."""
    over, jax_cls, port_cls = KINDS[kind]
    model = jax_model(name, readers["jax"], update_freq=UPDATE_FREQ, **over)
    jax_trainer = jax_cls(model)
    jax_trainer.compile(optimizer="adam", lr=LR, loss="mse", metrics=("ndcg@5",),
                        user_sample_n=10)
    jax_trainer.init_state(batch, seed=0)
    leaves = scaled_state(flat(jax_trainer.state.params))
    jax_trainer.state = jax_trainer.state.replace(params=as_tree(leaves),
                                                  target_params=as_tree(leaves))
    port = port_cls(port_model(name, readers["port"], update_freq=UPDATE_FREQ, **over))
    port.compile(optimizer="adam", lr=LR, loss="mse", metrics=("ndcg@5",), user_sample_n=10)
    port.init_state(to_torch(batch), seed=0)
    params_from_jax(leaves, port)
    return jax_trainer, port


def scaled_state(leaves):
    """``init_leaves``' scaling of a trainer's leaves: a packed row's table
    columns scale, its zero moments stay zero."""
    return {k: (v * 10.0 if v.dtype == np.float32 and "rnn/" not in k else v)
            for k, v in leaves.items()}


def jax_adam(jax_trainer):
    adam = [s for s in jax.tree_util.tree_leaves(
        jax_trainer.state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1

    def leaves(tree):
        tree = traverse_util.flatten_dict(jax.device_get(tree), sep="/")
        return {k: np.asarray(v) for k, v in tree.items() if not isinstance(v, optax.MaskedNode)}

    return leaves(adam[0].mu), leaves(adam[0].nu), int(adam[0].count)


def port_layout(layout_model, params, partial):
    """Flax leaves ``partial`` (filled from ``params`` where absent) as the
    port network's state dict."""
    return {k: v.clone() for k, v in
            load_leaves({**params, **partial}, layout_model).state_dict().items()}


def load_jax_state(port, jax_trainer, layout_model):
    """The port takes JAX's whole state (see the module docstring)."""
    state = jax_trainer.state
    params, target = flat(state.params), flat(state.target_params)
    load_leaves(params, port)
    load_leaves(target, port.state.target)
    mu, nu, count = jax_adam(jax_trainer)
    exp_avg, exp_avg_sq = (port_layout(layout_model, params, m) for m in (mu, nu))
    optimizer = port.state.optimizer
    dense = {id(p) for group in optimizer.param_groups for p in group["params"]}
    for key, param in port.model.named_parameters():
        if id(param) in dense:
            optimizer.state[param] = {"step": torch.tensor(float(count)),
                                      "exp_avg": exp_avg[key].clone(),
                                      "exp_avg_sq": exp_avg_sq[key].clone()}
    moments = getattr(state, "table_moments", None) or {}
    with torch.no_grad():
        for path, values in moments.items():
            for key, value in values.items():
                port.state.table_moments[path][key].copy_(torch.from_numpy(np.asarray(value)))
    port.state.step = int(state.step)
    return count


def adam_moved(label, got, want, v, step):
    got, want, v = (np.asarray(a, dtype=np.float64) for a in (got, want, v))
    window = np.sqrt(v / (1.0 - ADAM_B2 ** step)) < EPS_WINDOW
    err = np.abs(got - want)
    bad = ~window & (err > RTOL * np.abs(want) + ATOL)
    assert not bad.any(), f"{label}: {int(bad.sum())} values, max abs err {err[bad].max()}"
    assert (err[window] <= 1.01 * LR).all(), f"{label}: a value in the eps window"


def moments_close(label, got_m, want_m, got_v, want_v):
    np.testing.assert_allclose(got_m, want_m, rtol=RTOL, atol=M_ATOL, err_msg=label)
    np.testing.assert_allclose(np.sqrt(got_v), np.sqrt(want_v), rtol=RTOL, atol=SQRT_V_ATOL,
                               err_msg=label)


def gathered_once(port, batch):
    """The item ids the eval network gathers exactly once in the step."""
    spec = port.model.sharded_table_specs(to_torch(batch))["i"]
    ids, counts = np.unique(spec["ids"].numpy(), return_counts=True)
    return ids[counts == 1], ids


def check_int8(label, got_packed, want_packed, before, batch, port):
    once, touched = gathered_once(port, batch)
    got, want = got_packed.numpy(), np.asarray(want_packed)
    untouched = np.ones(got.shape[0], bool)
    untouched[touched] = False
    np.testing.assert_array_equal(got[untouched], before[untouched], err_msg=label)
    q_bytes = jqp.q_row_bytes(E, 8)
    np.testing.assert_array_equal(got[once, :q_bytes], want[once, :q_bytes],
                                  err_msg=f"{label} q of the ids gathered once")
    (gq, gs, ga), (wq, ws, wa) = (jqp.unpack_quantized_table(t, E, 8, 1) for t in (got, want))
    gq, gs, ga, wq, ws, wa = (np.asarray(a)[touched] for a in (gq, gs, ga, wq, ws, wa))
    diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
    assert diff.max() <= 1, label
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL, err_msg=label)
    np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=ATOL, err_msg=label)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", ["dqn", "lsrl"])
def test_each_step_from_jax_state(readers, name, kind):  # noqa: F811
    over = KINDS[kind][0]
    steps = train_batches(readers["jax"])
    jax_trainer, port = make_pair(name, kind, readers, steps[0])
    layout_model = port_model(name, readers["port"], **over).qnet
    tables = TABLES[name] if kind != "dense" else []
    if kind == "int8":
        tables = [t for t in tables if not t.startswith("i_")]
        assert port._table_lr == LR  # rowwise: no table_lr_hint, the shared lr
    for step in range(1, STEPS + 1):
        batch = steps[step - 1]
        load_jax_state(port, jax_trainer, layout_model)
        target_before = {k: v.clone() for k, v in port.state.target.state_dict().items()}
        int8_before = port.state.packed["i_q"].numpy().copy() if kind == "int8" else None
        want_loss = float(jax_trainer._train_step(batch))
        got_loss = float(port.train_step(batch))
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, err_msg=f"step {step}")
        assert port.state.step == step == int(jax_trainer.state.step)
        params, (mu, nu, count) = flat(jax_trainer.state.params), jax_adam(jax_trainer)
        label = f"{name} {kind} step {step}"
        # dense parameters and their Adam moments
        values = port_layout(layout_model, params, {})
        exp_avg, exp_avg_sq = (port_layout(layout_model, params, m) for m in (mu, nu))
        moments, checked = port.state.optimizer.state, 0
        for key, param in port.model.named_parameters():
            if param not in moments:
                continue
            checked += 1
            adam_moved(f"{label} {key}", param.detach().numpy(), values[key].numpy(),
                       exp_avg_sq[key].numpy(), step)
            moments_close(f"{label} {key}", moments[param]["exp_avg"].numpy(),
                          exp_avg[key].numpy(), moments[param]["exp_avg_sq"].numpy(),
                          exp_avg_sq[key].numpy())
        assert checked == len(mu)
        # the tables
        for path in tables:
            if kind == "packed":
                got, want = port.state.packed[path].numpy(), params[path]
                adam_moved(f"{label} {path}", got[:, :E], want[:, :E], want[:, 2 * E:3 * E], step)
                moments_close(f"{label} {path}", got[:, E:2 * E], want[:, E:2 * E],
                              got[:, 2 * E:3 * E], want[:, 2 * E:3 * E])
                np.testing.assert_array_equal(got[:, 3 * E:], want[:, 3 * E:])
            else:
                jax_moments = jax_trainer.state.table_moments[path]
                got_moments = port.state.table_moments[path]
                got = port.model.get_parameter(path.replace("/", ".")).detach().numpy()
                adam_moved(f"{label} {path}", got, params[path], jax_moments["v"], step)
                moments_close(f"{label} {path}", got_moments["m"].numpy(), jax_moments["m"],
                              got_moments["v"].numpy(), jax_moments["v"])
        if kind == "int8":
            check_int8(label, port.state.packed["i_q"], params["i_q"], int8_before, batch, port)
        # the target: the params after a sync step, untouched after the others
        own = port.model.state_dict()
        target = port.state.target.state_dict()
        for key, tensor in target.items():
            if step % UPDATE_FREQ == 0:
                assert torch.equal(tensor, own[key]), (label, key)
            else:
                assert torch.equal(tensor, target_before[key]), (label, key)
        synced = all(torch.equal(t, own[k]) for k, t in target.items())
        assert synced == (step % UPDATE_FREQ == 0), label


@pytest.mark.parametrize("kind", list(KINDS))
def test_target_sync_cadence(readers, kind):  # noqa: F811
    """target := params bit for bit every ``update_freq`` free eager steps."""
    over, _, port_cls = KINDS[kind]
    steps = train_batches(readers["port"])
    port = port_cls(port_model("dqn", readers["port"], update_freq=UPDATE_FREQ, **over))
    port.compile(optimizer="adam", lr=LR, loss="mse", metrics=("ndcg@5",), user_sample_n=10)
    port.init_state(to_torch(steps[0]), seed=0)
    synced_at = []
    for step, batch in enumerate(steps, start=1):
        port.train_step(batch)
        own = port.model.state_dict()
        if all(torch.equal(t, own[k]) for k, t in port.state.target.state_dict().items()):
            synced_at.append(step)
    assert synced_at == [3, 6]


def _fit(port, reader, scan_batches, seed=3):
    return port.fit(reader, batch_size=BATCH, epochs=8, verbose=0, dev_freq=4, seed=seed,
                    scan_batches=scan_batches)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_scan_batches_match_per_batch_and_jax(readers, kind):  # noqa: F811
    """``fit`` over 8 batch-"epochs": ``scan_batches`` 4 and 3 (windows 3, 1,
    3, 1: a graph a window size on the card) end bit-equal to 1, targets
    too; the per-batch run against JAX's ``fit`` from the same leaves."""
    over, jax_cls, port_cls = KINDS[kind]
    sample = readers["jax"].get_batch("train", np.arange(2))
    runs = {}
    for scan in (1, 4, 3):
        jax_trainer, port = make_pair("dqn", kind, readers, sample)
        history = _fit(port, readers["port"], scan)
        assert port.state.step == 8 and port.step_losses.shape == (8,)
        runs[scan] = (port, history)
    windows = {1: 8, 4: 2, 3: 4}
    for scan, (port, history) in runs.items():
        assert len(history.history["loss"]) == windows[scan], scan
        assert len(history.history["ndcg@5"]) == 2, scan
    base = runs[1][0]
    for scan in (4, 3):
        port = runs[scan][0]
        assert torch.equal(port.step_losses, base.step_losses), scan
        for model, want in ((port.model, base.model), (port.state.target, base.state.target)):
            for (key, got), (_, value) in zip(model.state_dict().items(),
                                              want.state_dict().items()):
                assert torch.equal(got, value), (scan, key)
        np.testing.assert_array_equal(runs[scan][1].history["ndcg@5"],
                                      runs[1][1].history["ndcg@5"])
    want = jax_trainer.fit(readers["jax"], batch_size=BATCH, epochs=8, verbose=0, dev_freq=4,
                           seed=3, scan_batches=1)
    got = runs[1][1]
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=RTOL)
    np.testing.assert_allclose(got.history["ndcg@5"], want.history["ndcg@5"], rtol=RTOL)


def test_trainer_refusals(readers):  # noqa: F811
    import pytorchrec_tpu_torch

    assert pytorchrec_tpu_torch.RLTrainer is RLTrainer  # a top-level name, as in JAX
    model = port_model("dqn", readers["port"])
    with pytest.raises(NotImplementedError):
        RLTrainer(model, device="cpu", mesh=object())
    with pytest.raises(TypeError):
        SparseRLTrainer(model.qnet, device="cpu")
    quantized = port_model("dqn", readers["port"], quantized_table=True)
    with pytest.raises(ValueError):
        RLTrainer(quantized, device="cpu")
    with pytest.raises(ValueError):
        SparseRLTrainer(quantized, device="cpu", packed_tables=True)
    port = RLTrainer(model, device="cpu", packed_transfer=False)
    port.compile(optimizer="adam", lr=LR, loss="mse", metrics=("ndcg@5",), user_sample_n=10)
    with pytest.raises(ValueError, match="packed_transfer"):
        port.fit(readers["port"], batch_size=BATCH, epochs=2, verbose=0, scan_batches=2)


def test_tables_stay_out_of_the_dense_optimizer(readers):  # noqa: F811
    port = SparseRLTrainer(port_model("lsrl", readers["port"]), device="cpu")
    port.compile(optimizer="adam", lr=LR, loss="mse", metrics=("ndcg@5",), user_sample_n=10)
    port.init_state(to_torch(readers["port"].get_batch("train", np.arange(2))), seed=0)
    dense = {id(p) for group in port.state.optimizer.param_groups for p in group["params"]}
    for path in TABLES["lsrl"]:
        assert id(port.model.get_parameter(path.replace("/", "."))) not in dense
    assert sorted(port.state.table_moments) == sorted(TABLES["lsrl"])


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_checkpoint_restores_the_target(readers, kind, tmp_path):  # noqa: F811
    """A checkpoint holds the target network (and, sparse, the state key):
    a trainer from another seed restored from it takes the next step as
    the saved one does, bit for bit, target included."""
    over, _, port_cls = KINDS[kind]
    steps = train_batches(readers["port"], n=4)

    def trainer(seed):
        port = port_cls(port_model("dqn", readers["port"], update_freq=UPDATE_FREQ, **over))
        port.compile(optimizer="adam", lr=LR, loss="mse", metrics=("ndcg@5",), user_sample_n=10)
        port.init_state(to_torch(steps[0]), seed=seed)
        return port

    saved = trainer(0)
    for batch in steps[:2]:
        saved.train_step(batch)
    path = str(tmp_path / "rl.pt")
    saved.save_checkpoint(path)
    restored = trainer(7)
    restored.restore_checkpoint(path)
    assert restored.state.step == 2
    for batch in steps[2:]:  # step 3 syncs the target
        assert torch.equal(saved.train_step(batch), restored.train_step(batch))
    for got, want in ((restored.model, saved.model), (restored.state.target, saved.state.target)):
        for (key, value), (_, expected) in zip(got.state_dict().items(),
                                               want.state_dict().items()):
            assert torch.equal(value, expected), key
