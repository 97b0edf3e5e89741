"""The port's ``Trainer.evaluate`` and ``predict`` against the JAX trainer's,
on the CPU.

A reader over seeded numpy arrays serves both trainers: the port reads it
only through ``get_dataset_size(split)``, ``get_train_dataset_size()`` and
``get_batch(split, indices)``; the JAX trainer also calls
``get_test_dataset_size()`` for its progress bar. Two models, each
initialised in JAX, given leaves that spread the scores out (kernels
N(0, 2 / fan_in), tables N(0, 1): under the init's N(0, 0.01) every score is
about 1e-4 and near ties abound) and loaded into the port with
``params_from_jax``:

* a small DIN (E=8, attention (16, 8), MLP (16, 8)) scoring leave-one-out
  rows of 10 candidates, the positive first, under
  ``metrics=("ndcg@10", "ndcg@3", "hit@3", "hit@1", "auc", "logloss")`` and
  ``user_sample_n=10``;
* a small DCN-v2 (3 sparse fields of vocab 50, E=4, 2 dense fields, 2 cross
  layers, MLP (8,)) scoring labelled rows point-wise under
  ``metrics=("auc", "logloss", "mse")``.

Each split's size leaves a padded last batch, which both trainers cut to
its valid rows. Predictions rtol 1e-5 (f32 sums in another order; atol 1e-6
for the scores that pass near zero, differences of sums of order 1); metrics
within 1e-6 of JAX's (of the value, where it passes 1: JAX means logloss and
MSE in float32), on data whose predictions lie no two within 1e-4 of
each other (checked), so that no rank can flip between the two; the
streaming partials within 1e-6 of JAX's streaming metrics.
"""

import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models import DCNv2 as JaxDCNv2
from pytorchrec_tpu.models.din import DIN as JaxDIN
from pytorchrec_tpu.training.trainer import Trainer as JaxTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.data import eval_batches, num_train_batches, train_batches
from pytorchrec_tpu_torch.models import DCNv2, DIN
from pytorchrec_tpu_torch.training import Trainer
from pytorchrec_tpu_torch.training.callbacks import CallbackList, ProgbarLogger
from pytorchrec_tpu_torch.utils import params_from_jax

USERS, ITEMS, E, S, N = 40, 300, 8, 5, 10
VOCAB, N_SPARSE, N_DENSE = 50, 3, 2
DIN_ROWS, DCN_ROWS, BATCH = 21, 150, 16
DIN_METRICS = ("ndcg@10", "ndcg@3", "hit@3", "hit@1", "auc", "logloss")
DCN_METRICS = ("auc", "logloss", "mse")
MIN_GAP = 1e-4


class ArrayReader:
    """Columns of numpy arrays by split; a batch is a row selection."""

    def __init__(self, splits):
        self.splits = splits

    def get_dataset_size(self, split):
        return len(next(iter(self.splits[split].values())))

    def get_train_dataset_size(self):
        return self.get_dataset_size("train")

    def get_test_dataset_size(self):  # the JAX trainer's progress bar reads it
        return self.get_dataset_size("test")

    def get_batch(self, split, indices):
        return {k: v[indices] for k, v in self.splits[split].items()}


def _din_columns(fc):
    col = fc.CategoricalColumnWithIdentity
    return dict(uid_column=col(feature_name="uid", category_num=USERS),
                iid_column=col(feature_name="iid", category_num=ITEMS),
                his_column=col(feature_name="pos_his", category_num=ITEMS),
                his_len_column=col(feature_name="pos_his_len", category_num=S + 1),
                label_column=col(feature_name="label", category_num=2))


def _din_split(rng, rows):
    lengths = rng.integers(0, S + 1, size=rows).astype(np.int32)
    his = rng.integers(1, ITEMS, size=(rows, S)).astype(np.int32)
    his[np.arange(S)[None, :] >= lengths[:, None]] = 0
    return {"uid": rng.integers(0, USERS, size=rows).astype(np.int32),
            # a leave-one-out row: the positive and N - 1 other items
            "iid": np.stack([rng.choice(ITEMS, N, replace=False) for _ in range(rows)]
                            ).astype(np.int32),
            "pos_his": his, "pos_his_len": lengths}


def _dcn_split(rng, rows):
    split = {f"c_{i}": rng.integers(0, VOCAB, rows).astype(np.int32) for i in range(N_SPARSE)}
    split.update({f"d_{i}": rng.normal(size=rows).astype(np.float32) for i in range(N_DENSE)})
    split["label"] = rng.integers(0, 2, rows).astype(np.int32)
    return split


def _dcn_kwargs(fc):
    return dict(sparse_columns=[fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                                 category_num=VOCAB)
                                for i in range(N_SPARSE)],
                dense_columns=[fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
                label_column=fc.CategoricalColumnWithIdentity(feature_name="label",
                                                              category_num=2),
                emb_size=4, num_cross_layers=2, layers=(8,))


def _spread(flat, rng):
    """New leaves that spread the scores out: kernels N(0, 2 / fan_in),
    tables N(0, 1); biases as the init left them."""
    out = {}
    for path, value in flat.items():
        leaf = path.split("/")[-1]
        if leaf == "embedding":
            out[path] = rng.standard_normal(value.shape).astype(np.float32)
        elif value.ndim >= 2 and leaf not in ("bs", "dense_factors") and not re.fullmatch(
                r"b\d+", leaf):
            scale = np.sqrt(2.0 / value.shape[-2])
            out[path] = (rng.standard_normal(value.shape) * scale).astype(np.float32)
        else:
            out[path] = value
    return out


def _case(name):
    """(reader, JAX trainer, port trainer) with the same scaled parameters."""
    rng = np.random.default_rng(11)
    if name == "din":
        reader = ArrayReader({"test": _din_split(rng, DIN_ROWS)})
        jax_model = JaxDIN(**_din_columns(jfc), emb_size=E, att_hidden_units=(16, 8),
                           mlp_layers=(16, 8))
        port_model = DIN(**_din_columns(tfc), emb_size=E, att_hidden_units=(16, 8),
                         mlp_layers=(16, 8), device="cpu",
                         generator=torch.Generator().manual_seed(0))
        metrics = dict(metrics=DIN_METRICS, user_sample_n=N)
    else:
        reader = ArrayReader({"test": _dcn_split(rng, DCN_ROWS)})
        kwargs = _dcn_kwargs(jfc)
        jax_model = JaxDCNv2(**{**kwargs, "sparse_columns": tuple(kwargs["sparse_columns"]),
                                "dense_columns": tuple(kwargs["dense_columns"])})
        port_model = DCNv2(**_dcn_kwargs(tfc), device="cpu",
                           generator=torch.Generator().manual_seed(0))
        metrics = dict(metrics=DCN_METRICS)
    jax_trainer = JaxTrainer(jax_model)
    jax_trainer.compile(optimizer="adam", lr=1e-3, loss="bce", **metrics)
    jax_trainer.init_state(reader.get_batch("test", np.arange(2)), seed=0)
    flat = _spread({k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(jax_trainer.state.params), sep="/").items()}, rng)
    jax_trainer.state = jax_trainer.state.replace(
        params=traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                             for k, v in flat.items()}))
    port = Trainer(params_from_jax(flat, port_model), device="cpu")
    port.compile(optimizer="adam", lr=1e-3, loss="bce", **metrics)
    return reader, jax_trainer, port


def _min_gap(predictions):
    flat = np.sort(np.asarray(predictions, dtype=np.float64).reshape(-1))
    return np.diff(flat).min()


@pytest.mark.parametrize("name", ["din", "dcnv2"])
def test_predict_matches_jax(name):
    reader, jax_trainer, port = _case(name)
    want = np.asarray(jax_trainer.predict(reader, batch_size=BATCH, verbose=0))
    got = port.predict(reader, batch_size=BATCH)
    rows = DIN_ROWS if name == "din" else DCN_ROWS
    assert rows % BATCH  # a padded last batch, cut to its valid rows
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == ((rows, N) if name == "din" else (rows,))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert _min_gap(want) > MIN_GAP and np.abs(want).max() > 1.0  # the scores spread out


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("name", ["din", "dcnv2"])
def test_evaluate_matches_jax(name, streaming):
    reader, jax_trainer, port = _case(name)
    want = jax_trainer.evaluate(reader, batch_size=BATCH, verbose=0, streaming=streaming)
    got = port.evaluate(reader, batch_size=BATCH, verbose=0, streaming=streaming)
    assert list(got) == list(want) == list(DIN_METRICS if name == "din" else DCN_METRICS)
    for metric, value in want.items():
        # JAX means logloss and MSE in float32: 1e-6 of the value where it passes 1
        assert abs(got[metric] - value) <= 1e-6 * max(1.0, abs(value)), (metric, got[metric],
                                                                          value)


@pytest.mark.parametrize("name", ["din", "dcnv2"])
def test_evaluate_is_the_metrics_of_predict(name):
    """``evaluate`` gives exactly ``MetricList`` of ``predict``'s output and
    its targets; streaming is exact for all but AUC, which is binned."""
    reader, _, port = _case(name)
    predictions = port.predict(reader, batch_size=BATCH)
    if name == "din":
        targets = np.zeros_like(predictions)
        targets[:, 0] = 1.0
    else:
        targets = reader.splits["test"]["label"].astype(np.float32)
    logs = port.evaluate(reader, batch_size=BATCH, verbose=0)
    assert logs == port.metrics(predictions, targets)
    streamed = port.evaluate(reader, batch_size=BATCH, verbose=0, streaming=True)
    for metric, value in logs.items():
        if metric == "auc":
            assert abs(streamed[metric] - value) < 2e-3
        else:
            np.testing.assert_allclose(streamed[metric], value, rtol=1e-6, err_msg=metric)


def test_padded_last_batch_is_cut_to_its_rows():
    """The last batch repeats its last row up to the batch size; predict
    returns only the split's rows."""
    reader, _, port = _case("dcnv2")
    got = port.predict(reader, batch_size=64)  # 64 + 64 + 22 rows
    assert got.shape == (DCN_ROWS,)
    batches = list(eval_batches(reader, "test", 64))
    assert [(len(batch["label"]), valid) for batch, valid in batches] == [
        (64, 64), (64, 64), (64, 22)]
    tail = batches[-1][0]
    np.testing.assert_array_equal(tail["c_0"][22:], tail["c_0"][21])  # the last row repeated
    np.testing.assert_array_equal(got[128:], port.make_serving_fn()(tail).numpy()[:22])


def test_loader_train_batches():
    reader = ArrayReader({"train": {"x": np.arange(10)}})
    assert num_train_batches(10, 4) == 2 and num_train_batches(10, 4, drop_last=False) == 3
    rows = [b["x"] for b in train_batches(reader, 4, np.random.default_rng(0))]
    assert len(rows) == 2 and all(len(r) == 4 for r in rows)
    assert len(set(np.concatenate(rows))) == 8
    rows = [b["x"] for b in train_batches(reader, 4, shuffle=False, drop_last=False)]
    np.testing.assert_array_equal(np.concatenate(rows), np.arange(10))


def test_verbose_runs_a_progress_bar():
    reader, _, port = _case("dcnv2")
    out = io.StringIO()
    bar = ProgbarLogger(verbose=2, out=out)
    logs = port.evaluate(reader, batch_size=64, verbose=2, callbacks=[bar])
    line = out.getvalue()
    assert line.startswith("3/3") and f"auc: {logs['auc']:.4f}" in line
    seen = []

    class Batches(ProgbarLogger):
        def on_predict_batch_end(self, batch, logs=None):
            seen.append(batch)

    port.predict(reader, batch_size=64, callbacks=CallbackList([Batches(verbose=0)]))
    assert seen == [0, 1, 2]


def test_compile_takes_jax_defaults():
    _, _, port = _case("dcnv2")
    port.compile()
    assert [m.name for m in port.metrics.metrics] == ["ndcg@10", "hit@10"]
    assert port.metrics.user_sample_n == 100
