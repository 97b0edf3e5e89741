"""The port's metrics (``pytorchrec_tpu_torch/metric``) against the JAX
package's (``pytorchrec_tpu/metric``), on seeded numpy inputs, on the CPU.

Tolerances: the positive ranks and Hit@k equal; NDCG@k rtol 1e-6 (JAX and
the port take the same float32 gains of the same ranks and sum them in
float32, in another order); AUC with ties
equal to 1e-12 (both are float64 rank sums); logloss and MSE rtol 1e-6 (JAX
means in float32, the port in float64). The streaming partials over batches
whose last one is padded (``valid``): the rank histogram equal, the AUC
histograms and sums rtol 1e-6, and ``partial_finalize`` rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.metric import metrics as jm
from pytorchrec_tpu_torch.metric import metrics as tm

USERS, N = 300, 10


def _candidate_scores(seed=0, users=USERS, n=N, ties=True):
    """``[users, n]`` scores, positive first; with ``ties``, a share of the
    rows has negatives tied with the positive."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(users, n)).astype(np.float32)
    scores[:, 0] += 0.8
    if ties:
        rows = rng.choice(users, users // 5, replace=False)
        scores[rows, 1 + rng.integers(0, n - 1, rows.size)] = scores[rows, 0]
    return scores


def _pointwise(seed=1, rows=2000, ties=True):
    """Logits and 0/1 labels; with ``ties``, logits on a coarse grid."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(rows) < 0.3).astype(np.float32)
    logits = (rng.normal(size=rows) + 1.2 * labels).astype(np.float32)
    if ties:
        logits = np.round(logits * 8) / 8
    return logits, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pos_ranks_equal_with_ties(seed):
    scores = _candidate_scores(seed)
    got = tm.pos_rank_from_scores(scores, N)
    np.testing.assert_array_equal(got, np.asarray(jm.pos_rank_from_scores(scores, N)))
    # the positive goes before its tied negatives, as a stable argsort puts it
    order = np.argsort(-scores, axis=1, kind="stable")
    np.testing.assert_array_equal(got, 1 + np.argmax(order == 0, axis=1))


@pytest.mark.parametrize("k", [1, 5, 10])
def test_rank_metrics_against_jax(k):
    scores = _candidate_scores(3)
    ranks = tm.pos_rank_from_scores(scores, N)
    hit, ndcg = tm.Hit(N, k), tm.NDCG(N, k)
    assert hit(scores) == float(jm.Hit(N, k)(jnp.asarray(scores)))
    assert hit.name == f"hit@{k}" and ndcg.name == f"ndcg@{k}"
    want = float(jm.NDCG(N, k)(jnp.asarray(scores)))
    np.testing.assert_allclose(ndcg(scores), want, rtol=1e-6)
    # the same float32 gains as JAX's, at the same ranks
    gains = np.where(ranks <= k, 1.0 / np.log2(ranks + 1.0), 0.0)
    np.testing.assert_allclose(ndcg(scores), np.mean(gains), rtol=1e-6)
    assert ndcg.fast_calc(ranks).dtype == np.float32


@pytest.mark.parametrize("ties", [True, False])
def test_auc_against_jax(ties):
    logits, labels = _pointwise(ties=ties)
    got = tm.AUC()(logits, labels)
    want = jm.AUC()(logits, labels)
    assert abs(got - want) <= 1e-12
    assert tm.AUC()(torch.from_numpy(logits), torch.from_numpy(labels)) == got
    assert tm.AUC()(logits, np.ones_like(labels)) == 0.5 == jm.AUC()(logits, np.ones_like(labels))


def test_logloss_and_mse_against_jax():
    logits, labels = _pointwise(ties=False)
    logits = logits * 6  # saturated logits too
    for port, ref in ((tm.LogLoss(), jm.LogLoss()), (tm.MSE(), jm.MSE())):
        np.testing.assert_allclose(port(logits, labels), ref(logits, labels), rtol=1e-6)


def test_get_metric_parses_as_jax_does():
    for name in ("ndcg@10", "HIT@3", "auc", "logloss", "mse", "auc/1", "logloss/0"):
        got, want = tm.get_metric(name, 50), jm.get_metric(name, 50)
        assert (type(got).__name__, got.name, got.user_sample_n) == (
            type(want).__name__, want.name, want.user_sample_n)
    for bad in ("nope", "ndcg@x", "rank@3", "ndcg@3/1"):
        with pytest.raises(ValueError):
            tm.get_metric(bad)


def test_metric_list_against_jax():
    scores = _candidate_scores(4)
    labels = np.zeros_like(scores)
    labels[:, 0] = 1.0
    names = ["ndcg@10", "hit@10", "ndcg@3", "hit@1", "auc", "logloss"]
    got = tm.MetricList(names, user_sample_n=N)(scores, labels)
    want = jm.MetricList(names, user_sample_n=N)(scores, labels)
    assert list(got) == names == list(want)
    for name in names:
        tol = {"auc": 1e-12, "ndcg@10": 1e-6, "ndcg@3": 1e-6, "logloss": 1e-6}.get(name, 0.0)
        np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=0.0, err_msg=name)
    same = tm.MetricList(names, user_sample_n=N)(torch.from_numpy(scores),
                                                  torch.from_numpy(labels))
    assert same == got
    with pytest.raises(AssertionError, match="user_sample_n"):
        tm.MetricList([tm.NDCG(10, 3), tm.Hit(20, 3)])


def test_task_slices_and_the_slice_mixing_guard():
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(400, 2)).astype(np.float32)
    target = (rng.random((400, 2)) < 0.4).astype(np.float32)
    names = ["auc/0", "auc/1", "logloss/1", "mse/0"]
    got = tm.MetricList(names)(pred, target)
    want = jm.MetricList(names)(pred, target)
    for name in names:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, err_msg=name)
    mixed = ["auc", "auc/1"]
    for cls in (tm.MetricList, jm.MetricList):
        with pytest.raises(AssertionError, match="cannot be combined"):
            cls(mixed)(pred, target)
    # one task column beside its slice is harmless: nothing is pooled
    one = ["auc", "auc/0"]
    got, want = tm.MetricList(one)(pred[:, :1], target[:, :1]), jm.MetricList(one)(
        pred[:, :1], target[:, :1])
    assert got["auc"] == got["auc/0"] and abs(got["auc"] - want["auc"]) <= 1e-12
    with pytest.raises(AssertionError, match="cannot be combined"):
        tm.MetricList(mixed).partial_update(tm.MetricList(mixed).partial_init(),
                                            torch.from_numpy(pred), torch.from_numpy(target), 400)
    with pytest.raises(AssertionError, match="multi-task"):
        tm.get_metric("auc/0")(pred[:, 0], target[:, 0])


def _stream(metric_list, batches, port: bool):
    state = metric_list.partial_init()
    for pred, target, valid in batches:
        if port:
            state = metric_list.partial_update(state, torch.from_numpy(pred),
                                               torch.from_numpy(target), valid)
        else:
            state = metric_list.partial_update(state, jnp.asarray(pred), jnp.asarray(target),
                                               jnp.asarray(valid))
    return state


def _padded_batches(pred, target, batch):
    """Eval batches of ``batch`` leading rows, the last one padded by
    repeating its last row (``data/loader.py``'s contract)."""
    out = []
    for start in range(0, pred.shape[0], batch):
        p, t = pred[start:start + batch], target[start:start + batch]
        valid = p.shape[0]
        if valid < batch:
            p = np.concatenate([p, np.repeat(p[-1:], batch - valid, axis=0)])
            t = np.concatenate([t, np.repeat(t[-1:], batch - valid, axis=0)])
        out.append((p, t, valid))
    return out


@pytest.mark.parametrize("layout", ["candidates", "pointwise", "tasks"])
def test_streaming_partials_against_jax(layout):
    rng = np.random.default_rng(6)
    if layout == "candidates":
        pred = _candidate_scores(7, users=250)
        target = np.zeros_like(pred)
        target[:, 0] = 1.0
        names = ["ndcg@10", "hit@10", "ndcg@2", "auc", "logloss", "mse"]
    elif layout == "pointwise":
        pred, target = _pointwise(8, rows=1003, ties=False)
        names = ["auc", "logloss", "mse"]
    else:
        pred = rng.normal(size=(517, 2)).astype(np.float32)
        target = (rng.random((517, 2)) < 0.4).astype(np.float32)
        names = ["auc/0", "auc/1", "logloss/1", "mse/0"]
    batches = _padded_batches(pred, target, 64)
    assert batches[-1][2] < 64  # the last batch is padded
    port, ref = tm.MetricList(names, user_sample_n=N), jm.MetricList(names, user_sample_n=N)
    got, want = _stream(port, batches, True), _stream(ref, batches, False)
    assert sorted(got) == sorted(want)
    for key in want:
        want_value = np.asarray(want[key])
        assert got[key].dtype == torch.float32 and tuple(got[key].shape) == want_value.shape
        if key == "rank_hist":
            np.testing.assert_array_equal(got[key].numpy(), want_value)
        else:
            np.testing.assert_allclose(got[key].numpy(), want_value, rtol=1e-6, err_msg=key)
    got_logs, want_logs = port.partial_finalize(got), ref.partial_finalize(want)
    for name in names:
        np.testing.assert_allclose(got_logs[name], want_logs[name], rtol=1e-6, err_msg=name)
    # exact metrics of the whole split: the rank metrics and the sums
    exact = port(pred, target)
    for name in names:
        if not name.startswith("auc"):
            np.testing.assert_allclose(got_logs[name], exact[name], rtol=1e-6, err_msg=name)
        else:
            assert abs(got_logs[name] - exact[name]) < 2e-3  # binned to 1/16384 of sigmoid
