"""``Trainer.fit`` over the port's readers against the JAX trainer's over
the JAX package's, on the CPU: the path from a dataset on disk to trained
weights.

Each package generates the same synthetic dataset in a work dir of its own
and reads it with its own reader (its own split, negative and history
files), so nothing one package wrote is read by the other:

* a small DIN (E=8, attention (16, 8), MLP (16, 8)) on the history reader,
  leave-one-out with 9 dev negatives, pair-wise (a negative drawn anew by
  the reader's ``train_neg_sample`` each epoch, the JAX reader's stream)
  under BPR, dev NDCG and Hit;
* a small DCN-v2 (3 sparse fields, 3 z-scored dense fields, E=4, 2 cross
  layers, MLP (8,)) on the CTR reader, the sequential split, point-wise
  BCE, dev AUC and logloss.

Both start from the same weights: JAX's init spread out (kernels N(0, 2 /
fan_in), table columns N(0, 0.5)) and loaded into the port with
``params_from_jax``, so that gradients stay out of Adam's eps window. 2 epochs, ``drop_last=True`` (``tests/test_torch_fit.py``
says why). Epoch losses, dev metrics and the dev predictions after: rtol
1e-4; every parameter leaf (the packed tables with their moments): rtol
1e-4 and, for values near zero, an atol of N · 1e-4 · lr after N free
steps, the rule of ``tests/test_torch_fit_steps_fused.py`` (``ROADMAP.md``
C7: drift of f32 sums in another order, which
``tests/test_torch_fit_steps_stepped.py`` shows is no fault of the port;
DIN's 56 steps leave 2 of 512 attention weights 3.2e-6 apart). A value
whose gradient is in Adam's eps window (JAX's bias-corrected RMS gradient
under 1e-6 at the end, as ``tests/test_torch_zoo_training.py::eps_window``
finds them: DIN's last attention bias, whose gradient the pool's softmax
makes zero but for rounding) may instead lie within N lr, in at most 1% of
a parameter's values.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import data as jax_data
from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.data.process.datasets.synthetic import (
    generate_synthetic_ctr as jax_generate_ctr,
    generate_synthetic_ml as jax_generate_ml,
)
from pytorchrec_tpu.models import DCNv2 as JaxDCNv2
from pytorchrec_tpu.models.din import DIN as JaxDIN
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer as JaxSparse
from pytorchrec_tpu_torch import data
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2, DIN
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import leaves_of
from test_torch_zoo_training import adam_moments

RTOL, LR, S = 1e-4, 1e-2, 5
ADAM_B2, EPS_WINDOW = 0.999, 1e-6
CASES = {
    "din": dict(reader="HistoryDataReader", loss="bpr", metrics=("ndcg@3", "hit@3", "ndcg@10"),
                batch=32, reader_kwargs=dict(split_mode="leave_k_out", warm_n=5, leave_k=1,
                                             neg_sample_n=9, train_mode="pair_wise",
                                             max_his_len=S)),
    "dcnv2": dict(reader="CTRDataReader", loss="bce", metrics=("auc", "logloss"), batch=64,
                  reader_kwargs=dict(split_mode="sequential_split", warm_n=1, vt_ratio=0.1,
                                     train_mode="point_wise")),
}
DENSE, SPARSE = ("d_0", "d_1", "d_2"), ("c_0", "c_1", "c_2")


def _generate(package_generators, name):
    generate_ml, generate_ctr = package_generators
    if name == "din":
        generate_ml("ReaderFit", n_users=40, n_items=120, seed=5, markov_strength=0.5,
                    n_clusters=6)
    else:
        generate_ctr("ReaderFit", n_rows=900, n_dense=3,
                     sparse_vocab_sizes={"c_0": 50, "c_1": 8, "c_2": 200}, seed=5)


def _model_kwargs(name, fc, columns):
    col = fc.CategoricalColumnWithIdentity
    if name == "din":
        items = columns["iid"].category_num
        return dict(uid_column=columns["uid"], iid_column=columns["iid"],
                    his_column=col(feature_name="pos_his", category_num=items),
                    his_len_column=col(feature_name="pos_his_len", category_num=S + 1),
                    label_column=columns["label"], emb_size=8, att_hidden_units=(16, 8),
                    mlp_layers=(16, 8))
    return dict(sparse_columns=tuple(columns[c] for c in SPARSE),
                dense_columns=tuple(columns[c] for c in DENSE), label_column=columns["label"],
                emb_size=4, num_cross_layers=2, layers=(8,), unified_embedding=True)


def _flat(params):
    params = jax.device_get(params)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _spread(flat, emb, seed=7):
    """Kernels N(0, 2 / fan_in), each table's first ``emb`` columns N(0, 0.5)
    (a packed leaf's moment and staging columns stay as they are)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, value in flat.items():
        leaf = path.split("/")[-1]
        if leaf == "embedding":
            value = value.copy()
            value[:, :emb] = rng.normal(0.0, 0.5, size=(value.shape[0], emb))
        elif value.dtype == np.float32 and value.ndim >= 2 and leaf not in (
                "bs", "dense_factors") and not re.fullmatch(r"b\d+", leaf):
            value = (rng.standard_normal(value.shape) * np.sqrt(2.0 / value.shape[-2])
                     ).astype(np.float32)
        out[path] = value
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_fit_over_readers_matches_jax(name, tmp_path, monkeypatch):
    case = CASES[name]
    readers = {}
    for tag, package, generators in (
            ("jax", jax_data, (jax_generate_ml, jax_generate_ctr)),
            ("port", data, (data.generate_synthetic_ml, data.generate_synthetic_ctr))):
        monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(tmp_path / tag))
        _generate(generators, name)
        readers[tag] = getattr(package, case["reader"])("ReaderFit", **case["reader_kwargs"],
                                                         random_seed=2020)
    port_reader, jax_reader = readers["port"], readers["jax"]
    sample = jax_reader.get_batch("train", np.arange(2))
    compiled = dict(optimizer="adam", lr=LR, loss=case["loss"], metrics=case["metrics"],
                    user_sample_n=10)

    jax_kwargs = _model_kwargs(name, jfc, jax_reader.get_feature_column_dict())
    jax_trainer = JaxSparse((JaxDIN if name == "din" else JaxDCNv2)(**jax_kwargs),
                            packed_tables=True)
    jax_trainer.compile(**compiled)
    jax_trainer.init_state(sample, seed=0)
    flat = _spread(_flat(jax_trainer.state.params), jax_kwargs["emb_size"])
    jax_trainer.state = jax_trainer.state.replace(params=traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}))

    port_kwargs = _model_kwargs(name, tfc, port_reader.get_feature_column_dict())
    if name == "dcnv2":
        port_kwargs.update(sparse_columns=list(port_kwargs["sparse_columns"]),
                           dense_columns=list(port_kwargs["dense_columns"]))
    model = (DIN if name == "din" else DCNv2)(**port_kwargs, device="cpu",
                                              generator=torch.Generator().manual_seed(0))
    port = SparseEmbeddingTrainer(model, device="cpu", packed_tables=True)
    port.compile(**compiled)
    port.init_state(port_reader.get_batch("train", np.arange(2)), seed=0)
    params_from_jax(flat, port)

    fit = dict(batch_size=case["batch"], epochs=2, verbose=0, seed=3, drop_last=True)
    want = jax_trainer.fit(jax_reader, **fit)
    got = port.fit(port_reader, **fit)
    steps = 2 * (port_reader.get_train_dataset_size() // case["batch"])
    assert port.state.step == int(jax_trainer.state.step) == len(port.step_losses) == steps > 4
    assert list(got.history) == list(want.history) == ["loss", *case["metrics"]]
    for key, values in want.history.items():
        np.testing.assert_allclose(got.history[key], values, rtol=RTOL, err_msg=key)
    np.testing.assert_array_equal(port_reader.train_iid_pair_array if name == "din" else 0,
                                  jax_reader.train_iid_pair_array if name == "din" else 0)

    want_leaves = _flat(jax_trainer.state.params)
    got_leaves = leaves_of(port)
    assert set(got_leaves) <= set(want_leaves)
    assert any(v.ndim == 2 and v.shape[0] > 100 for v in want_leaves.values())
    _, nu = adam_moments(jax_trainer)
    atol = steps * 1e-4 * LR
    for path, value in got_leaves.items():
        got, expected = value.numpy(), want_leaves[path]
        moment = nu.get(path)  # a packed table keeps its moments in its own columns
        window = (moment is not None and moment.shape == expected.shape
                  and np.sqrt(moment / (1.0 - ADAM_B2 ** steps)) < EPS_WINDOW)
        err = np.abs(got - expected)
        exempt = window & (err > atol + RTOL * np.abs(expected))
        assert exempt.sum() <= max(1, exempt.size // 100), (path, int(np.sum(exempt)))
        np.testing.assert_allclose(got[~exempt], expected[~exempt], rtol=RTOL, atol=atol,
                                   err_msg=path)
        assert (err[exempt] <= steps * LR).all(), path
    dev = np.asarray(jax_trainer.predict(jax_reader, split="dev", batch_size=case["batch"],
                                         verbose=0))
    np.testing.assert_allclose(port.predict(port_reader, split="dev", batch_size=case["batch"]),
                               dev, rtol=RTOL, atol=1e-5)
