"""The zoo's training on the CPU: 5 steps of FunkSVD, SVD++, NCF, GRU4Rec
and SASRec (shared and per-layer blocks) under the port's trainers against
the JAX package's.

The models and batches of ``tests/test_torch_zoo_models.py`` (E=8, 50 users,
200 items, histories of 5-10 ids then PAD 0, so PAD rows are gathered and go
through the lazy update; item ids skewed, so they repeat within a batch;
rows and weights N(0, 0.1)) are set up in JAX with ``compile("adam",
lr=1e-3)`` and ``init_state(seed=0)``, under

* ``Trainer``: dense Adam over every parameter, tables included;
* ``SparseEmbeddingTrainer(packed_tables=True)``: every table a packed
  ``[V, 64]`` f32 leaf under lazy Adam (SVD++'s E=1 biases too), the rest
  under the dense Adam;
* ``QuantizedEmbeddingTrainer(packed_tables=True)``: the int8 item tables
  (``i_q``; SVD++'s ``implicit_i_q`` and NCF's ``mf_i_q`` and ``mlp_i_q``
  beside it, each salted on its own path) under rowwise Adagrad at the
  model's ``table_lr_hint`` (the shared lr where it has none), the rest
  under the dense Adam.

Their leaves load into the port's trainer with ``params_from_jax``; both
take 5 steps on the same numpy batches of 16 rows: BPR on ``[B, 2]`` for
FunkSVD, SVD++ and NCF, BCE on ``[B, 2]`` against the one-hot-first label for
GRU4Rec and SASRec, and MSE on point-wise ratings for FunkSVD. NCF and
SASRec run without dropout here (the two frameworks draw different masks;
``test_torch_zoo_models.py`` tests the port's masks).

Tolerances, as ``tests/test_torch_din_training.py``'s: each step's loss
rtol 1e-5; after 5 steps every packed leaf (moments included), dense
parameter and dense Adam moment rtol 1e-4 / atol 1e-6; int8 rows' scale and
accumulator so, their q values off by at most one in at most 0.1% of them;
scores after training rtol 1e-4 / atol 1e-6. A dense value whose gradient
fell in Adam's eps window at some step (``eps_window``) may instead lie
within 5 lr, in at most 1% of a parameter's values, as ``chip_smoke.py``'s
``adam_values_agree`` and ``tests/test_torch_fit_steps_stepped.py`` hold
such values: NCF's user rows under BPR meet it.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_zoo_models import (
    BATCH,
    E,
    ITEMS,
    LAYOUTS,
    as_tree,
    flat,
    jax_model,
    make_batch,
    port_model,
    scaled,
)
from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu_torch.ops.kernels.quantize import requantize_rows
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer as TorchQuantizedTrainer
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import _port_key, flax_path

STEPS, LR = 5, 1e-3
RTOL, ATOL = 1e-4, 1e-6
ADAM_B2, EPS_WINDOW = 0.999, 1e-6
KERNELS = (segmented_sum_scan, requantize_rows, scatter_set_rows)
LOSSES = {"funk_svd": "bpr", "svdpp": "bpr", "ncf": "bpr", "gru4rec": "bce", "sasrec": "bce",
          "sasrec_layers": "bce"}
PORT_TRAINERS = {"f32": TorchTrainer,
                 "packed_f32": lambda m, **k: TorchSparseTrainer(m, packed_tables=True, **k),
                 "int8_packed": lambda m, **k: TorchQuantizedTrainer(m, packed_tables=True, **k)}
# the packed tables of each model (f32 leaves; int8: the u8 leaves)
PACKED = {
    "funk_svd": (["i_embeddings/embedding", "u_embeddings/embedding"], ["i_q"]),
    "svdpp": (["i_bias/embedding", "i_embeddings/embedding", "implicit_i_embeddings/embedding",
               "u_bias/embedding", "u_embeddings/embedding"], ["i_q", "implicit_i_q"]),
    "ncf": (["mf_i_embeddings/embedding", "mf_u_embeddings/embedding",
             "mlp_i_embeddings/embedding", "mlp_u_embeddings/embedding"], ["mf_i_q", "mlp_i_q"]),
    **{name: (["i_embeddings/embedding"], ["i_q"]) for name in ("gru4rec", "sasrec",
                                                                "sasrec_layers")},
}


def batches(loss, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    if loss == "mse":
        return [make_batch(rng, label="rating") for _ in range(n)]
    return [make_batch(rng, candidates=2, label="pair") for _ in range(n)]


def pair(name, layout, loss, steps_batches):
    """The JAX trainer and the port's, from the same scaled leaves."""
    kwargs, make = LAYOUTS[layout]
    jax_trainer = make(jax_model(name, **kwargs))
    jax_trainer.compile(optimizer="adam", lr=LR, loss=loss, metrics=())
    jax_trainer.init_state(steps_batches[0], seed=0)
    leaves = scaled(flat(jax_trainer.state.params))
    jax_trainer.state = jax_trainer.state.replace(params=as_tree(leaves))
    port = PORT_TRAINERS[layout](port_model(name, **kwargs), device="cpu")
    port.compile(optimizer="adam", lr=LR, loss=loss)
    port.init_state(steps_batches[0], seed=0)
    params_from_jax(leaves, port)
    return jax_trainer, port


def step_both(jax_trainer, port, steps_batches):
    """Both trainers take the steps, each loss held to rtol 1e-5. Returns,
    by flax path, the dense values whose gradient fell in Adam's eps
    window at some step (``eps_window``)."""
    before = [k.launches for k in KERNELS]
    window = {}
    for step, batch in enumerate(steps_batches):
        want = float(jax_trainer._train_step(batch))
        got = port.train_step(batch)
        assert got.shape == () and port.state.step == step + 1
        np.testing.assert_allclose(float(got), want, rtol=1e-5, err_msg=f"step {step}")
        for path, inside in eps_window(jax_trainer, step + 1).items():
            window[path] = window.get(path, False) | inside
    assert [k.launches for k in KERNELS] == before  # the CPU runs the plain versions
    return window


def adam_moments(jax_trainer):
    """JAX's dense Adam moments (mu, nu) by flax path; masked tables absent."""
    adam = [s for s in jax.tree_util.tree_leaves(
        jax_trainer.state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1

    def leaves(tree):
        return {k: v for k, v in flat(tree).items() if not isinstance(v, optax.MaskedNode)}

    return leaves(adam[0].mu), leaves(adam[0].nu)


def eps_window(jax_trainer, step):
    """JAX's dense values whose gradient took part in this step's moments
    (``nu > 0``) but whose bias-corrected RMS gradient ``sqrt(nu_hat)`` is
    under ``EPS_WINDOW``: there ``lr * m_hat / (sqrt(v_hat) + eps)`` turns
    the last bits of a gradient that summed to nearly nothing (BPR's
    ``g_pos = -g_neg`` through a shared user row and equal relu masks sums
    to zero exactly) into a share of lr, so the two frameworks' values part
    by up to lr a step there."""
    _, nu = adam_moments(jax_trainer)
    return {path: (v > 0) & (np.sqrt(v / (1.0 - ADAM_B2 ** step)) < EPS_WINDOW)
            for path, v in nu.items()}


def assert_dense_match(name, layout, port, jax_trainer, packed, window):
    """Every dense parameter and its Adam moments, port against JAX. A value
    in ``window`` (``eps_window`` at some step) outside the tolerance is
    held to ``STEPS * lr``; such values may be at most 1% of a
    parameter's."""
    kwargs = LAYOUTS[layout][0]
    leaves = flat(jax_trainer.state.params)
    want = params_from_jax(leaves, port_model(name, **kwargs)).state_dict()
    for key, value in port.model.state_dict().items():
        path = flax_path(key)
        if value.dtype != torch.float32 or path in packed:
            continue
        got, expected = value.numpy(), want[key].numpy()
        inside = window.get(path, np.zeros(expected.shape[::-1], bool))
        inside = inside.T if _port_key(path)[1] == "transpose" else inside
        err = np.abs(got - expected)
        exempt = inside & (err > ATOL + RTOL * np.abs(expected))
        assert exempt.sum() <= max(1, exempt.size // 100), (key, int(exempt.sum()))
        np.testing.assert_allclose(got[~exempt], expected[~exempt], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
        assert (err[exempt] <= STEPS * LR).all(), key
    params = dict(port.model.named_parameters())
    moments = port.state.optimizer.state
    mu, nu = adam_moments(jax_trainer)
    assert mu and set(mu) == set(nu)
    for path in set(mu) - packed:  # a packed table's moments are its own columns
        key, transform = _port_key(path)
        state = moments[params[key]]
        for got, value in ((state["exp_avg"], mu[path]), (state["exp_avg_sq"], nu[path])):
            value = value.T if transform == "transpose" else value
            if transform == "table_columns" and value.shape[1] > got.shape[1]:
                value = value[:, :got.shape[1]]
            np.testing.assert_allclose(got.numpy(), value, rtol=RTOL, atol=ATOL, err_msg=path)


def assert_scores_match(jax_trainer, port):
    serve_batch = make_batch(np.random.default_rng(7), candidates=5, label=None)
    want = np.asarray(jax_trainer.make_serving_fn()(serve_batch))
    got = port.make_serving_fn()(serve_batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def touched_items(name, steps_batches):
    touched = np.zeros(ITEMS, bool)
    for batch in steps_batches:
        touched[batch["iid"].reshape(-1)] = True
        if name in ("gru4rec", "sasrec", "sasrec_layers"):
            touched[batch["his"].reshape(-1)] = True
    return touched


def int8_rows_match(got_packed, want_packed, rows):
    (gq, gs, ga), (wq, ws, wa) = (jqp.unpack_quantized_table(np.asarray(t), E, 8, 1)
                                  for t in (got_packed, want_packed))
    gq, gs, ga, wq, ws, wa = (np.asarray(a)[rows] for a in (gq, gs, ga, wq, ws, wa))
    diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000), diff.sum()
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=ATOL)
    return ga


@pytest.mark.parametrize("name", list(LOSSES))
def test_five_dense_train_steps_match_jax(name):
    steps_batches = batches(LOSSES[name])
    jax_trainer, port = pair(name, "f32", LOSSES[name], steps_batches)
    window = step_both(jax_trainer, port, steps_batches)
    assert_dense_match(name, "f32", port, jax_trainer, set(), window)
    assert_scores_match(jax_trainer, port)


@pytest.mark.parametrize("name", list(LOSSES))
def test_five_packed_train_steps_match_jax(name):
    steps_batches = batches(LOSSES[name])
    jax_trainer, port = pair(name, "packed_f32", LOSSES[name], steps_batches)
    paths = PACKED[name][0]
    assert sorted(port.state.packed) == paths
    assert all(t.shape[1] == 64 for t in port.state.packed.values())
    addresses = {path: t.data_ptr() for path, t in port.state.packed.items()}
    item_path = paths[0] if name != "svdpp" else "i_embeddings/embedding"
    start = port.state.packed[item_path].clone()
    window = step_both(jax_trainer, port, steps_batches)
    assert {path: t.data_ptr() for path, t in port.state.packed.items()} == addresses
    leaves = flat(jax_trainer.state.params)
    for path in paths:
        np.testing.assert_allclose(port.state.packed[path].numpy(), leaves[path], rtol=RTOL,
                                   atol=ATOL, err_msg=path)
    touched = torch.from_numpy(touched_items(name, steps_batches))
    items = port.state.packed[item_path]
    assert torch.equal(items[~touched], start[~touched])  # lazy: untouched rows stay
    if name in ("gru4rec", "sasrec", "sasrec_layers"):
        assert touched[0]  # the PAD row is gathered and goes through the update
    assert_dense_match(name, "packed_f32", port, jax_trainer, set(paths), window)
    assert_scores_match(jax_trainer, port)


@pytest.mark.parametrize("name", list(LOSSES))
def test_five_int8_packed_train_steps_match_jax(name):
    steps_batches = batches(LOSSES[name])
    jax_trainer, port = pair(name, "int8_packed", LOSSES[name], steps_batches)
    q_paths = PACKED[name][1]
    assert sorted(port.state.packed) == q_paths
    hint = getattr(port.model, "table_lr_hint", None)
    assert port._table_lr == (hint if hint is not None else LR)
    starts = {path: port.state.packed[path].clone() for path in q_paths}
    window = step_both(jax_trainer, port, steps_batches)
    leaves = flat(jax_trainer.state.params)
    touched = touched_items(name, steps_batches)
    for path in q_paths:
        packed = port.state.packed[path]
        assert packed.data_ptr() == port.model.get_buffer(path).data_ptr()
        if path == "implicit_i_q":
            rows = np.zeros(ITEMS, bool)
            for batch in steps_batches:
                rows[batch["imp"].reshape(-1)] = True
        else:
            rows = touched
        untouched = torch.from_numpy(~rows)
        assert torch.equal(packed[untouched], starts[path][untouched])
        int8_rows_match(packed, leaves[path], rows)
    assert_dense_match(name, "int8_packed", port, jax_trainer, set(q_paths), window)
    assert_scores_match(jax_trainer, port)


def test_svdpp_int8_salts_its_two_tables_apart():
    """The two packed tables of one step draw different rounding bits: the
    same grads on both give rows that differ."""
    steps_batches = batches("bpr", n=1)
    _, port = pair("svdpp", "int8_packed", "bpr", steps_batches)
    scalars = port.state.scalars
    row = torch.from_numpy(scalars.host_rows(1, 1))[0]
    assert int(scalars.salt(row, "i_q")) != int(scalars.salt(row, "implicit_i_q"))


def test_funk_svd_mse_on_pointwise_ratings():
    steps_batches = batches("mse")
    assert steps_batches[0]["iid"].shape == (BATCH,)
    jax_trainer, port = pair("funk_svd", "packed_f32", "mse", steps_batches)
    step_both(jax_trainer, port, steps_batches)
    leaves = flat(jax_trainer.state.params)
    for path in PACKED["funk_svd"][0]:
        np.testing.assert_allclose(port.state.packed[path].numpy(), leaves[path], rtol=RTOL,
                                   atol=ATOL, err_msg=path)
    serve = make_batch(np.random.default_rng(8), label=None)
    np.testing.assert_allclose(port.make_serving_fn()(serve).numpy(),
                               np.asarray(jax_trainer.make_serving_fn()(serve)), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["gru4rec", "sasrec"])
def test_fit_steps_matches_jax(name):
    steps_batches = batches(LOSSES[name], n=4)
    jax_trainer, port = pair(name, "packed_f32", LOSSES[name], steps_batches)
    want = jax_trainer.fit_steps(iter(steps_batches), steps=4, log_every=2, verbose=0)
    got = port.fit_steps(iter(steps_batches), steps=4, log_every=2)
    assert got.epoch == [0, 1] and port.state.step == 4
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=1e-5)
