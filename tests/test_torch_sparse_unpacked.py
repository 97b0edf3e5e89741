"""Unpacked tables on the CPU: the row-sparse updates and
``SparseEmbeddingTrainer``'s default (``packed_tables=False``), the port
against JAX.

The functions ``sparse_lazy_adam``, ``sparse_adagrad`` and
``sparse_rowwise_adagrad`` take the same table, moments, ids (one id 40
times, another 17 times, the rest random) and grads as JAX's. With dyadic
grads (multiples of 2**-10 below 1/2, whose sums are exact in any order)
every stored bit equals JAX's, the moments stored as ``m + (new - m)`` (the
test shows rows where that differs from ``new``); with normal grads the
duplicates' sums run in another order (``dedup_row_grads``: a scan against
JAX's running sum) and the results agree within rtol 1e-5 / atol 1e-6
(sums of up to 40 grads that cancel, then squared or divided).

The trainer: DCN-v2 on a unified table, DeepFM and DLRM on per-field tables
(3 sparse fields of vocab 50, E=4, 2 dense fields), for each table optimizer
and each ``rows_injection`` JAX takes (None, False, and True for the unified
table; per-field tables raise on True in both), 5 steps from JAX's
``init_state(seed=0)`` on batches of 64 Zipf-skewed ids. Tolerances (as
``tests/test_torch_deepfm_training.py``, seed 2 for the same reason): each
loss rtol 1e-5; tables, moments and dense parameters rtol 1e-4 / atol 1e-6,
except table values whose gradient's RMS over the steps lies under 1e-6
(Adam's ``sqrt(v_hat)``, C7's eps window; Adagrad's ``sqrt(acc)``, where
gradients of about 1e-9 make ``g / sqrt(acc)`` a ratio of last bits), held
within 5 steps of lr.
Then JAX's auto-resolution of ``rows_injection``, and a checkpoint's
``table_moments`` restored in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu import models as jmodels
from pytorchrec_tpu.ops import sparse_update as jsu
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch import models as tmodels
from pytorchrec_tpu_torch.ops import sparse_update as tsu
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer as TorchSparseTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

VOCAB, N_SPARSE, N_DENSE, BATCH, STEPS, LR, E = 50, 3, 2, 64, 5, 1e-2, 4
MODELS = {
    "DCNv2": ({"num_cross_layers": 2, "layers": (8,), "unified_embedding": True}),
    "DeepFM": ({"layers": (8,)}),
    "DLRM": ({"bottom_layers": (8,), "top_layers": (8,)}),
}
OPTIMIZERS = ("adam", "adagrad", "rowwise_adagrad")
TRAINER_CASES = [(m, opt, inj) for m in MODELS for opt in OPTIMIZERS
                 for inj in ((None, False, True) if m == "DCNv2" else (None, False))]


# ---------------------------------------------------------------- functions


def _update_inputs(dyadic: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    v, e = 300, 16
    ids = np.concatenate([np.full(40, 7), np.full(17, 299), rng.integers(0, v, 88)])
    ids = rng.permutation(ids).astype(np.int32)
    if dyadic:
        dvec = (rng.integers(-512, 512, (ids.size, e)) / 1024.0).astype(np.float32)
    else:
        dvec = rng.normal(size=(ids.size, e)).astype(np.float32)
    table = rng.normal(size=(v, e)).astype(np.float32)
    m = (rng.normal(size=(v, e)) * 0.1).astype(np.float32)
    second = np.abs(rng.normal(size=(v, e)) * 0.1).astype(np.float32)
    acc = np.abs(rng.normal(size=v)).astype(np.float32)
    return ids, dvec, table, m, second, acc


def _run_both(name, dyadic):
    """(JAX's arrays, the port's) after one update of ``name``."""
    ids, dvec, table, m, second, acc = _update_inputs(dyadic)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    before = (segmented_sum_scan.launches, scatter_set_rows.launches)
    if name == "adam":
        want = jsu.sparse_lazy_adam(j(table), j(m), j(second), j(ids), j(dvec), jnp.asarray(4),
                                    lr=LR)
        got = tsu.sparse_lazy_adam(t(table), t(m), t(second), t(ids), t(dvec), 4, lr=LR)
    elif name == "adagrad":
        want = jsu.sparse_adagrad(j(table), j(second), j(ids), j(dvec), lr=LR)
        got = tsu.sparse_adagrad(t(table), t(second), t(ids), t(dvec), lr=LR)
    else:
        want = jsu.sparse_rowwise_adagrad(j(table), j(acc), j(ids), j(dvec), lr=LR)
        got = tsu.sparse_rowwise_adagrad(t(table), t(acc), t(ids), t(dvec), lr=LR)
    assert (segmented_sum_scan.launches, scatter_set_rows.launches) == before  # CPU: plain
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_unpacked_updates_bit_exact_on_dyadic_grads(name):
    want, got = _run_both(name, dyadic=True)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_unpacked_updates_close_on_normal_grads(name):
    want, got = _run_both(name, dyadic=False)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_moments_store_old_plus_difference():
    """The stored moment is ``m + (new_m - m)``, JAX's scatter-add, not
    ``new_m``: on these inputs some values differ between the two, and the
    port's equal JAX's."""
    ids, dvec, table, m, second, _ = _update_inputs(dyadic=True)
    want = np.asarray(jsu.sparse_lazy_adam(*map(jnp.asarray, (table, m, second, ids, dvec)),
                                           jnp.asarray(4), lr=LR)[1])
    got = tsu.sparse_lazy_adam(*map(torch.from_numpy, (table.copy(), m.copy(), second.copy(),
                                                        ids, dvec)), 4, lr=LR)[1].numpy()
    g = tsu.dedup_row_grads(torch.from_numpy(ids), torch.from_numpy(dvec))
    unique = g.ids[g.mask > 0].long()
    m_rows = torch.from_numpy(m)[unique]
    new_m = 0.9 * m_rows + (1.0 - 0.9) * g.rows[g.mask > 0]
    assert not torch.equal(m_rows + (new_m - m_rows), new_m)  # the two stores differ here
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[unique.numpy()], (m_rows + (new_m - m_rows)).numpy())


def test_untouched_rows_and_padding_stay():
    ids, dvec, table, m, second, acc = _update_inputs(dyadic=False)
    got = tsu.sparse_lazy_adam(*map(torch.from_numpy, (table.copy(), m.copy(), second.copy(),
                                                        ids, dvec)), 4, lr=LR)
    untouched = np.setdiff1d(np.arange(table.shape[0]), ids)
    for before, after in zip((table, m, second), got):
        np.testing.assert_array_equal(after.numpy()[untouched], before[untouched])
    t, a = tsu.sparse_rowwise_adagrad(torch.from_numpy(table.copy()), torch.from_numpy(acc.copy()),
                                      torch.from_numpy(ids), torch.from_numpy(dvec), lr=LR)
    np.testing.assert_array_equal(a.numpy()[untouched], acc[untouched])
    assert (a.numpy()[np.unique(ids)] > acc[np.unique(ids)]).all()


# ------------------------------------------------------------------ trainer


def _columns(fc):
    return dict(
        sparse_columns=tuple(fc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                              category_num=VOCAB)
                             for i in range(N_SPARSE)),
        dense_columns=tuple(fc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)),
        label_column=fc.CategoricalColumnWithIdentity(feature_name="label", category_num=2))


def _batches(n=STEPS, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        # ids skewed towards a few hot values, so one id repeats 10+ times
        batch = {f"c_{i}": np.minimum(rng.zipf(1.5, BATCH) - 1, VOCAB - 1).astype(np.int32)
                 for i in range(N_SPARSE)}
        batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32)
                      for i in range(N_DENSE)})
        batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
        out.append(batch)
    return out


def _flat(tree):
    tree = jax.device_get(tree)
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _port_model(name):
    return getattr(tmodels, name)(**_columns(tfc), emb_size=E, **MODELS[name], device="cpu",
                                  generator=torch.Generator().manual_seed(0))


def _pair(name, table_optimizer, rows_injection, batches):
    jax_trainer = SparseEmbeddingTrainer(
        getattr(jmodels, name)(**_columns(jfc), emb_size=E, **MODELS[name]),
        table_optimizer=table_optimizer, rows_injection=rows_injection)
    jax_trainer.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    jax_trainer.init_state(batches[0], seed=0)
    port = TorchSparseTrainer(_port_model(name), device="cpu", table_optimizer=table_optimizer,
                              rows_injection=rows_injection)
    port.compile(optimizer="adam", lr=LR, loss="bce", metrics=())
    port.init_state(batches[0], seed=0)
    params_from_jax(_flat(jax_trainer.state.params), port)
    return jax_trainer, port


def _table_close(label, got, want, rms):
    """rtol 1e-4 / atol 1e-6, but for values whose gradient's RMS over the
    steps (``rms``, from JAX's moments: Adam's ``sqrt(v_hat)``, Adagrad's
    ``sqrt(acc)``, per value or per row) lies under 1e-6, held within 5
    steps of lr: there each step's ``g / rms`` is a ratio of sums that
    cancelled to their last bits (C7's eps window; Adagrad has no eps to
    damp it)."""
    window = np.broadcast_to(rms < 1e-6, want.shape)
    np.testing.assert_allclose(got[~window], want[~window], rtol=1e-4, atol=1e-6, err_msg=label)
    assert (np.abs(got[window] - want[window]) <= STEPS * LR).all(), label


@pytest.mark.parametrize("name,table_optimizer,rows_injection", TRAINER_CASES)
def test_five_unpacked_steps_match_jax(name, table_optimizer, rows_injection):
    batches = _batches()
    jax_trainer, port = _pair(name, table_optimizer, rows_injection, batches)
    assert port.rows_injection == jax_trainer.rows_injection
    assert not port.state.packed and set(port.state.table_moments) == set(
        jax_trainer.state.table_moments)
    tables = {p: port.model.get_parameter(p.replace("/", ".")) for p in port.state.table_moments}
    addresses = {p: t.data_ptr() for p, t in tables.items()}
    for step, batch in enumerate(batches):
        want = float(jax_trainer._train_step(batch))
        np.testing.assert_allclose(float(port.train_step(batch)), want, rtol=1e-5,
                                   err_msg=f"step {step}")
    assert {p: t.data_ptr() for p, t in tables.items()} == addresses  # updated in place

    flat = _flat(jax_trainer.state.params)
    bias2 = 1.0 - 0.999 ** STEPS
    for path, moments in _flat(jax_trainer.state.table_moments).items():
        table_path, key = path.rsplit("/", 1)
        got = port.state.table_moments[table_path][key].numpy()
        np.testing.assert_allclose(got, moments, rtol=1e-4, atol=1e-6, err_msg=path)
    for path, table in tables.items():
        moments = jax_trainer.state.table_moments[path]
        second = np.asarray(moments["v"]) / bias2 if "v" in moments else np.asarray(moments["acc"])
        rms = np.sqrt(second if second.ndim == 2 else second[:, None])
        _table_close(path, table.detach().numpy(), flat[path], rms)
    got = port.model.state_dict()
    want = params_from_jax(flat, _port_model(name)).state_dict()
    for key, value in want.items():
        if key.replace(".", "/") not in tables:
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)

    serve_batch = {k: v for k, v in _batches(1, seed=7)[0].items() if k != "label"}
    np.testing.assert_allclose(port.make_serving_fn()(serve_batch).numpy(),
                               np.asarray(jax_trainer.make_serving_fn()(serve_batch)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["DeepFM", "DLRM"])
def test_per_field_tables_refuse_forced_injection(name):
    """``rows_injection=True`` needs ``sharded_table_specs``, which per-field
    tables lack in both packages (JAX asserts at its first step)."""
    port = TorchSparseTrainer(_port_model(name), device="cpu", rows_injection=True)
    port.compile()
    with pytest.raises(ValueError):
        port.init_state(_batches(1)[0], seed=0)
    packed = TorchSparseTrainer(_port_model(name), device="cpu", packed_tables=True)
    packed.compile()
    with pytest.raises(ValueError):  # packed tables need the injection too
        packed.init_state(_batches(1)[0], seed=0)


@pytest.mark.parametrize("unified", [True, False])
def test_rows_injection_auto_resolution(unified):
    """As JAX's ``tests/test_sparse_update.py::test_rows_injection_auto_
    resolution``: on for unified tables, off for per-field ones, then a
    step on the resolved path."""
    batch = _batches(1)[0]
    kwargs = dict(emb_size=E, unified_embedding=unified)
    jax_trainer = SparseEmbeddingTrainer(jmodels.FM(**_columns(jfc), **kwargs))
    jax_trainer.compile(optimizer="adam", lr=0.05, loss="bce", metrics=())
    jax_trainer.init_state(batch, seed=0)
    port = TorchSparseTrainer(tmodels.FM(**_columns(tfc), **kwargs, device="cpu"), device="cpu")
    assert port.rows_injection is None
    port.compile(optimizer="adam", lr=0.05, loss="bce")
    port.init_state(batch, seed=0)
    assert port.rows_injection is jax_trainer.rows_injection is unified
    assert np.isfinite(float(port.train_step(batch)))


@pytest.mark.parametrize("table_optimizer", OPTIMIZERS)
def test_checkpoint_restores_table_moments_in_place(tmp_path, table_optimizer):
    batches = _batches(4)
    port = TorchSparseTrainer(_port_model("DLRM"), device="cpu", table_optimizer=table_optimizer)
    port.compile(optimizer="adam", lr=LR, loss="bce")
    port.init_state(batches[0], seed=0)
    for batch in batches[:2]:
        port.train_step(batch)
    path = str(tmp_path / "ckpt.pt")
    port.save_checkpoint(path)
    saved = torch.load(path, weights_only=True)["table_moments"]
    assert set(saved) == {f"emb_c_{i}/embedding" for i in range(N_SPARSE)}
    after = [float(port.train_step(b)) for b in batches[2:]]
    moments = {p: {k: (t.data_ptr(), t.clone()) for k, t in m.items()}
               for p, m in port.state.table_moments.items()}
    port.restore_checkpoint(path)
    for p, m in port.state.table_moments.items():
        for k, t in m.items():
            assert t.data_ptr() == moments[p][k][0]
            assert torch.equal(t, saved[p][k]) and not torch.equal(t, moments[p][k][1])
    assert [float(port.train_step(b)) for b in batches[2:]] == after
    for p, m in port.state.table_moments.items():
        for k, t in m.items():
            assert torch.equal(t, moments[p][k][1])
