"""The slice end to end on the CPU: two-tower scores, the item index and
retrieval from the port against JAX.

A small TwoTower (E=8, towers (16, 8), 60 users, 200 items) is initialised in
JAX (``model.init``) with its f32 item table, the same table as a packed
``[V, 64]`` f32 leaf (columns past E filled with noise the model must not
read), or the int8 packed ``i_q``. Its dense leaves and f32 tables are then
scaled from the init's N(0, 0.01) by ``WEIGHT_SCALE`` to N(0, 0.3), so tower
outputs and scores are spread (at 0.01 every tower output is about its
biases and every user ranks the items alike). The leaves go through
``params_from_jax``; both frameworks score the same numpy batches:
point-wise rows, candidate rows ``[B, 3]`` and the train-time in-batch
``[B, B]`` layout (with the logQ correction from a float64 column and
accidental-hit masking), normalized and not.

Retrieval runs on the same index in both frameworks (JAX's, converted), so
ids must be equal. Tolerances: scores rtol 1e-5 / atol
2e-5 (f32 sums in another order: a score near 0 is a difference of terms of
order 1 / temperature = 20, so its error is 1e-6 of that, absolute); the f32
index rtol 1e-5 / atol 1e-6 (unit vectors); the bf16 index within one bf16
ulp of JAX's (both round an f32 vector that differs in its last bits).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models.two_tower import TwoTower as JaxTwoTower
from pytorchrec_tpu.models.two_tower import drop_diagonal as jax_drop_diagonal
from pytorchrec_tpu.serving import retrieval as jret
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import TwoTower
from pytorchrec_tpu_torch.models.two_tower import drop_diagonal
from pytorchrec_tpu_torch.ops.kernels.retrieval_topk import bin_max_scores
from pytorchrec_tpu_torch.serving import build_item_index, make_retrieve_fn, retrieval
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer, SparseEmbeddingTrainer, Trainer
from pytorchrec_tpu_torch.utils import params_from_jax

USERS, ITEMS, E, LAYERS, BATCH = 60, 200, 8, (16, 8), 12
RTOL, ATOL = 1e-5, 2e-5
INDEX_ATOL = 1e-6
WEIGHT_SCALE = 30.0
TABLES = {"f32": {}, "packed_f32": {}, "int8_packed": {"quantized_table": True}}


def _columns(fc, items=ITEMS):
    col = fc.CategoricalColumnWithIdentity
    return dict(uid_column=col(feature_name="uid", category_num=USERS),
                iid_column=col(feature_name="iid", category_num=items),
                label_column=col(feature_name="label", category_num=2))


def _kwargs(table, normalize, **extra):
    return dict(emb_size=E, layers=LAYERS, normalize=normalize, **TABLES[table], **extra)


@functools.cache
def _leaves(table, normalize, items=ITEMS):
    """Flax leaves of a TwoTower with this item table, spread as the module
    docstring says."""
    model = JaxTwoTower(**_columns(jfc, items), **_kwargs(table, normalize))
    sample = {"uid": jnp.zeros((4,), jnp.int32), "iid": jnp.zeros((4,), jnp.int32)}
    params = model.init(jax.random.PRNGKey(0), sample, False)["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    flat = {k: v if k == "i_q" else v * np.float32(WEIGHT_SCALE) for k, v in flat.items()}
    if table == "packed_f32":
        rng = np.random.default_rng(1)
        for path in ("u_embeddings/embedding", "i_embeddings/embedding"):
            packed = rng.normal(size=(flat[path].shape[0], 64)).astype(np.float32)
            packed[:, :E] = flat[path]
            flat[path] = packed
    return flat


def _jax_pair(table, normalize, items=ITEMS, **extra):
    flat = _leaves(table, normalize, items)
    if table == "packed_f32":  # the JAX model's own table is the first E columns
        flat = {k: v[:, :E] if k.endswith("/embedding") else v for k, v in flat.items()}
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    return JaxTwoTower(**_columns(jfc, items), **_kwargs(table, normalize, **extra)), params


def _port(table, normalize, items=ITEMS, **extra):
    model = TwoTower(**_columns(tfc, items), **_kwargs(table, normalize, **extra), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    return params_from_jax(_leaves(table, normalize, items), model)


def _port_key(path):
    """The port's state-dict key of a two-tower flax leaf."""
    names = {"kernel": "weight", "bias": "bias", "embedding": "embedding"}
    tower = re.fullmatch(r"(\w+)/Dense_(\d+)/Dense_0/(kernel|bias)", path)
    if tower:
        return f"{tower[1]}.layers.{tower[2]}.linear.{names[tower[3]]}"
    module, _, leaf = path.rpartition("/")
    return f"{module}.{names[leaf]}" if module else path


def test_whole_tree_loads_into_the_model_and_each_packed_trainer():
    """Every two-tower leaf has its place (the converter's existing rules):
    into a model for each table layout, and whole packed leaves into the
    sparse and the quantized trainer right after ``init_state``; an unknown
    leaf raises."""
    sample = {"uid": np.zeros(4, np.int32), "iid": np.zeros((4, 2), np.int32)}
    for table, trainer_cls in (("f32", None), ("packed_f32", SparseEmbeddingTrainer),
                               ("int8_packed", QuantizedEmbeddingTrainer)):
        flat = _leaves(table, True)
        assert {"user_mlp/Dense_1/Dense_0/kernel", "item_proj/bias"} <= set(flat)
        model = _port(table, True)
        state = model.state_dict()
        for path, value in flat.items():
            want = torch.from_numpy(np.array(value))
            if path.endswith("kernel"):
                want = want.T
            elif path.endswith("/embedding"):
                want = want[:, :E]
            torch.testing.assert_close(state[_port_key(path)], want, rtol=0, atol=0, msg=path)
        with pytest.raises(KeyError):
            params_from_jax({**flat, "user_tower/kernel": flat["user_proj/kernel"]},
                            _port(table, True))
        if trainer_cls is None:
            continue
        trainer = trainer_cls(_port(table, True), device="cpu", packed_tables=True)
        trainer.compile(optimizer="adam", lr=1e-2, loss="softmax")
        trainer.init_state(sample, seed=0)
        params_from_jax(flat, trainer)
        for path, packed in trainer.state.packed.items():
            assert torch.equal(packed, torch.from_numpy(np.array(flat[path])))  # whole rows, in place
        torch.testing.assert_close(trainer.model.item_proj.weight,
                                   torch.from_numpy(np.array(flat["item_proj/kernel"])).T)


def _batch(mode, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"uid": rng.integers(0, USERS, size=BATCH).astype(np.int32)}
    if mode == "pointwise":
        batch["iid"] = rng.integers(0, ITEMS, size=BATCH).astype(np.int32)
        batch["label"] = rng.integers(0, 2, size=BATCH).astype(np.int32)
    else:
        iid = rng.integers(0, ITEMS, size=(BATCH, 3)).astype(np.int32)
        iid[5, 0] = iid[2, 0] = iid[9, 0]  # duplicate positives: accidental hits
        batch["iid"] = iid
    if mode == "in_batch_logq":
        batch[TwoTower.Q_KEY] = rng.uniform(0.01, 0.5, size=BATCH)  # float64, as numpy makes it
    return batch


def test_drop_diagonal_matches_jax():
    x = np.random.default_rng(0).normal(size=(7, 7)).astype(np.float32)
    got = drop_diagonal(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_drop_diagonal(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.stack([np.delete(row, i) for i, row in enumerate(x)]))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("mode", ["pointwise", "candidates", "in_batch", "in_batch_logq"])
@pytest.mark.parametrize("table", list(TABLES))
def test_scores_match_jax(table, mode, normalize):
    extra = {"mask_accidental_hits": True} if mode == "in_batch_logq" else {}
    jax_model, params = _jax_pair(table, normalize, **extra)
    model = _port(table, normalize, **extra)
    batch = _batch(mode)
    train = mode.startswith("in_batch")
    want, want_target = jax_model.apply(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                        train, rngs={"dropout": jax.random.PRNGKey(1)})
    with torch.no_grad():
        got, target = model({k: torch.as_tensor(v) for k, v in batch.items()}, train=train)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.shape == ((BATCH,) if mode == "pointwise" else
                         (BATCH, BATCH) if train else (BATCH, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(target.numpy(), np.asarray(want_target))
    if mode == "in_batch_logq":
        assert int((got.numpy() == -1e9).sum()) == 6  # rows 2, 5, 9: two masked columns each


@pytest.mark.parametrize("table", list(TABLES))
def test_serving_fn_scores_without_a_label(table):
    """``Trainer(model).make_serving_fn()`` on point-wise and candidate rows,
    as JAX's ``model.apply``; B7 is never launched (nor, on the CPU, any
    kernel)."""
    jax_model, params = _jax_pair(table, True)
    serve = Trainer(_port(table, True), device="cpu").make_serving_fn()
    before = bin_max_scores.launches
    for mode in ("pointwise", "candidates"):
        batch = {k: v for k, v in _batch(mode, seed=3).items() if k != "label"}
        want, _ = jax_model.apply(params, {k: jnp.asarray(v) for k, v in batch.items()}, False)
        np.testing.assert_allclose(serve(batch).numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert bin_max_scores.launches == before


@pytest.mark.parametrize("table", list(TABLES))
def test_item_index_matches_jax(table):
    jax_model, params = _jax_pair(table, True)
    model = _port(table, True)
    want = jret.build_item_index(jax_model, params, ITEMS, batch_size=64, dtype=jnp.float32)
    got = build_item_index(model, ITEMS, batch_size=64, dtype=torch.float32)
    assert got.shape == (ITEMS, LAYERS[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=INDEX_ATOL)
    want16 = np.asarray(jret.build_item_index(jax_model, params, ITEMS, batch_size=64)
                        .astype(jnp.float32))
    got16 = build_item_index(model, ITEMS, batch_size=64)
    assert got16.dtype == torch.bfloat16  # the default, as in JAX
    ulp = np.spacing(np.abs(want16).astype(np.float32)) * 2.0**16  # bf16 keeps 8 of f32's 24 bits
    assert (np.abs(got16.float().numpy() - want16) <= ulp).all()
    assert (got16.float().numpy() == want16).mean() > 0.99


def _index_pair(items, dtype, normalize=True):
    """JAX's item index of this corpus and the same values as a torch tensor."""
    jax_model, params = _jax_pair("f32", normalize, items)
    index = jret.build_item_index(jax_model, params, items, batch_size=64, dtype=dtype)
    torch_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return (jax_model, params, index,
            torch.from_numpy(np.array(index.astype(jnp.float32))).to(torch_dtype))


def _assert_retrieval_matches(got, want):
    (gs, gi), (ws, wi) = got, want
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("items,chunk", [(200, 1 << 30), (200, 64), (201, 64)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_exact_retrieval_matches_jax(items, chunk, dtype):
    """One block, equal chunks (200 = 4 x 50) and a ragged last chunk
    (201: 4 chunks of 64, the last one 9 rows), as tests/test_two_tower.py."""
    jax_model, params, index, port_index = _index_pair(items, dtype)
    u_ids = np.arange(8, dtype=np.int32)
    want = jret.make_retrieve_fn(jax_model, chunk_items=chunk)(params, index, jnp.asarray(u_ids),
                                                               7)
    got = make_retrieve_fn(_port("f32", True, items), chunk_items=chunk)(port_index, u_ids, 7)
    _assert_retrieval_matches(got, want)


def test_approx_runs_the_exact_path():
    """JAX's ``approx_max_k`` gives the exact top-k on the CPU; the port's
    ``approx=True`` runs the exact path, so both agree id for id."""
    jax_model, params, index, port_index = _index_pair(ITEMS, jnp.float32, normalize=False)
    u_ids = np.arange(8, dtype=np.int32)
    want = jret.make_retrieve_fn(jax_model, chunk_items=64, approx=True, recall_target=0.99)(
        params, index, jnp.asarray(u_ids), 10)
    port = _port("f32", False)
    got = make_retrieve_fn(port, chunk_items=64, approx=True)(port_index, u_ids, 10)
    _assert_retrieval_matches(got, want)
    _assert_retrieval_matches(make_retrieve_fn(port, chunk_items=64)(port_index, u_ids, 10), want)


@pytest.mark.parametrize("k", [1, 10, 70, 128])
@pytest.mark.parametrize("items", [70, 5000])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_retrieval_matches_jax(dtype, items, k):
    """B7's bins (on the CPU, its plain version) then the exact top-k: 70
    items leave 58 pad-only bins, so k=128 reaches past the valid bins into
    the -inf ones, whose pad ids must come in JAX's order; 5000 items in
    super-chunks of 4 x 2048 rows give 2 super-chunks (256 bins)."""
    jax_model, params, index, port_index = _index_pair(items, dtype)
    u_ids = np.arange(BATCH, dtype=np.int32)
    group = 16 if items == 70 else 2
    want = jret.make_retrieve_fn(jax_model, approx="fused", fused_group=group)(
        params, index, jnp.asarray(u_ids), k)
    before = bin_max_scores.launches
    got = make_retrieve_fn(_port("f32", True, items), approx="fused", fused_group=group)(
        port_index, u_ids, k)
    assert bin_max_scores.launches == before  # the CPU runs the plain version
    _assert_retrieval_matches(got, want)
    if k > items:
        assert (got[0][:, items:] == float("-inf")).all() and (got[1][:, items:] >= items).all()


@pytest.mark.parametrize("chunk", [1 << 30, 64])
def test_exact_top_k_masks_rows_past_n_valid(chunk):
    """``_topk_scores(n_valid=...)``: rows from ``n_valid`` on score -inf
    before any selection, as in JAX (its corpus-sharded path's tail)."""
    _, _, index, port_index = _index_pair(ITEMS, jnp.float32)
    u_vec = np.random.default_rng(4).normal(size=(5, LAYERS[-1])).astype(np.float32)
    want = jret._topk_scores(jnp.asarray(u_vec), index, 20, None, chunk, False, 0.99,
                             n_valid=jnp.int32(150))
    got = retrieval._topk_scores(torch.from_numpy(u_vec), port_index, 20, None, chunk,
                                 n_valid=150)
    _assert_retrieval_matches(got, want)
    assert int(got[1].max()) < 150
