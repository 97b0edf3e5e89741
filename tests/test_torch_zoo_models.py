"""The factorization and sequence zoo on the CPU: FunkSVD, SVD++, NCF,
GRU4Rec and SASRec from the port against their JAX twins, and the ops they
add (``ops/gru.py::MaskedGRU``, SASRec's attention and encoder).

Small models (E=8, 50 users, 200 items, histories of 10 steps of which each
row's 5-10 are ids and the rest PAD 0, GRU hidden 8, SASRec 2 layers in the
shared and the per-layer form, NCF ``layers=(8,)``) are initialised in JAX
under the trainer that owns each table layout: per-table f32 under
``Trainer``, packed f32 leaves under ``SparseEmbeddingTrainer(packed_tables=
True)``, int8 packed ``*_q`` rows under ``QuantizedEmbeddingTrainer(
packed_tables=True)``. Every table row and normal-initialised weight is then
scaled to N(0, 0.1) (``scaled``, as DIN's rows in ``chip_smoke.py``); the
leaves go through ``params_from_jax`` and the port's scorer scores the same
numpy batches as the flax model, point-wise and ``[B, 5]``, at rtol 1e-5 /
atol 1e-7 (f32 sums in another order; scores are of order 1e-2 to 1).

Units: the masked GRU's final state and its gradients against JAX with
rows of length 0 and S; the attention's global max far from the row maxima
(the weights and gradients of JAX, then a max so large that every score
under it rounds to the same value: rows attend uniformly, as in JAX, where
a per-row max tells their scores apart), and its gradient with a tie
at the global max; SVD++'s empty implicit history (NaN in the
same places); dropout masks drawn from the trainer's generator.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pytorchrec_tpu import feature_column as jfc
from pytorchrec_tpu.models.funk_svd import FunkSVD as JaxFunkSVD
from pytorchrec_tpu.models.gru4rec import GRU4Rec as JaxGRU4Rec
from pytorchrec_tpu.models.ncf import NCF as JaxNCF
from pytorchrec_tpu.models.sasrec import SASRec as JaxSASRec
from pytorchrec_tpu.models.svdpp import SVDPP as JaxSVDPP
from pytorchrec_tpu.ops import attention as jax_attention
from pytorchrec_tpu.ops.gru import MaskedGRU as JaxMaskedGRU
from pytorchrec_tpu.training.quantized_trainer import QuantizedEmbeddingTrainer
from pytorchrec_tpu.training.sparse_trainer import SparseEmbeddingTrainer
from pytorchrec_tpu.training.trainer import Trainer
from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import NCF, SASRec, SVDPP, FunkSVD, GRU4Rec
from pytorchrec_tpu_torch.ops import MaskedGRU, scaled_dot_product_attention
from pytorchrec_tpu_torch.ops.attention import SASRecBlock, sasrec_encoder
from pytorchrec_tpu_torch.training import Trainer as TorchTrainer
from pytorchrec_tpu_torch.utils import params_from_jax

USERS, ITEMS, E, S, H, BATCH, N = 50, 200, 8, 10, 8, 16, 5
MIN_LEN = 5  # each history holds 5 to S ids, then PAD
RTOL, ATOL = 1e-5, 1e-7
# table rows and normal-initialised weights N(0, 0.1): ten times the init's
WEIGHT_SCALE = 10.0

# model -> (JAX class, port class, size keywords)
MODELS = {
    "funk_svd": (JaxFunkSVD, FunkSVD, dict(emb_size=E)),
    "svdpp": (JaxSVDPP, SVDPP, dict(emb_size=E)),
    "ncf": (JaxNCF, NCF, dict(emb_size=E, layers=(8,), dropout=0.0)),
    "gru4rec": (JaxGRU4Rec, GRU4Rec, dict(emb_size=E, hidden_size=H)),
    "sasrec": (JaxSASRec, SASRec, dict(emb_size=E, max_his_len=S, num_layers=2, dropout=0.0)),
    "sasrec_layers": (JaxSASRec, SASRec, dict(emb_size=E, max_his_len=S, num_layers=2,
                                              dropout=0.0, share_layer_weights=False)),
}
SEQUENCE = ("gru4rec", "sasrec", "sasrec_layers")

# layout -> (model keywords, JAX trainer)
LAYOUTS = {
    "f32": ({}, Trainer),
    "packed_f32": ({}, lambda m: SparseEmbeddingTrainer(m, packed_tables=True)),
    "int8_packed": ({"quantized_table": True},
                    lambda m: QuantizedEmbeddingTrainer(m, packed_tables=True)),
}


def columns(fc, name):
    col = fc.CategoricalColumnWithIdentity
    label = col(feature_name="label", category_num=6)
    if name in SEQUENCE:
        return dict(iid_column=col(feature_name="iid", category_num=ITEMS),
                    his_column=col(feature_name="his", category_num=ITEMS),
                    his_len_column=col(feature_name="his_len", category_num=S + 1),
                    label_column=label)
    cols = dict(uid_column=col(feature_name="uid", category_num=USERS),
                iid_column=col(feature_name="iid", category_num=ITEMS), label_column=label)
    if name == "svdpp":
        cols["iids_column"] = col(feature_name="imp", category_num=ITEMS)
    return cols


def jax_model(name, **kwargs):
    cls, _, sizes = MODELS[name]
    return cls(**columns(jfc, name), **{**sizes, **kwargs})


def port_model(name, seed=0, **kwargs):
    _, cls, sizes = MODELS[name]
    return cls(**columns(tfc, name), **{**sizes, **kwargs}, device="cpu",
               generator=torch.Generator().manual_seed(seed))


def _history(rng, rows, min_len=MIN_LEN):
    lengths = rng.integers(min_len, S + 1, size=rows).astype(np.int32)
    his = np.minimum(rng.zipf(1.5, (rows, S)), ITEMS - 1).astype(np.int32)
    his[np.arange(S)[None, :] >= lengths[:, None]] = 0  # PAD after the history
    return his, lengths


def make_batch(rng, rows=BATCH, candidates=None, label="pair"):
    """A batch of every field the zoo reads: ``uid``, ``iid`` (``[rows]``, or
    ``[rows, candidates]`` positive first; item ids skewed, so they repeat
    within a batch),
    the history ``his``/``his_len`` and SVD++'s implicit ``imp``; ``label``:
    ``"pair"`` the one-hot-first ``[rows, candidates]``, the negatives made
    to differ from the positive, as a reader's negative sampling draws them
    (a pair of one item has an exactly zero gradient, which XLA's fused
    sums round to about 1e-11 and Adam's eps window turns into 1e-6 of a
    step), ``"binary"`` 0/1
    a row, ``"rating"`` 1..5 a row, None no label (serving)."""
    shape = rows if candidates is None else (rows, candidates)
    his, lengths = _history(rng, rows)
    imp, _ = _history(rng, rows)
    batch = {"uid": rng.integers(0, USERS, size=rows).astype(np.int32),
             "iid": np.minimum(rng.zipf(1.5, shape), ITEMS - 1).astype(np.int32),
             "his": his, "his_len": lengths, "imp": imp}
    if label == "pair":  # training rows: negatives differ from the positive
        iid = batch["iid"]
        same = iid[:, 1:] == iid[:, :1]
        iid[:, 1:][same] = np.broadcast_to(iid[:, :1] % (ITEMS - 1) + 1, iid[:, 1:].shape)[same]
        batch["label"] = np.zeros(shape, np.int32)
        batch["label"][:, 0] = 1
    elif label == "binary":
        batch["label"] = rng.integers(0, 2, size=rows).astype(np.int32)
    elif label == "rating":
        batch["label"] = rng.integers(1, 6, size=rows).astype(np.int32)
    return batch


def flat(tree):
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def scaled(leaves, emb=E):
    """Every table row and normal-initialised weight times ``WEIGHT_SCALE``:
    f32 tables in their first ``emb`` columns (a packed leaf's moments and
    staging are zero), u8 packed rows through their scale field; the GRU's
    uniform weights, LayerNorm's and ``global_bias`` stay."""
    out = {}
    for path, value in leaves.items():
        value = value.copy()
        if value.dtype == np.uint8:  # q || scale || acc || staging
            value[:, emb:emb + 4] = (value[:, emb:emb + 4].copy().view(np.float32)
                                     * np.float32(WEIGHT_SCALE)).view(np.uint8)
        elif path.startswith("rnn/") or "LayerNorm" in path or path == "global_bias":
            pass
        elif path.endswith("embedding") and value.shape[1] > emb:
            value[:, :emb] *= np.float32(WEIGHT_SCALE)
        else:
            value *= np.float32(WEIGHT_SCALE)
        out[path] = value
    return out


def as_tree(leaves):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in leaves.items()})


@functools.lru_cache(maxsize=None)
def jax_trainer(name, layout):
    """The JAX trainer of ``layout``, its initial leaves scaled."""
    kwargs, make = LAYOUTS[layout]
    trainer = make(jax_model(name, **kwargs))
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce", metrics=())
    trainer.init_state(make_batch(np.random.default_rng(0), label="binary"), seed=0)
    trainer.state = trainer.state.replace(params=as_tree(scaled(flat(trainer.state.params))))
    return trainer


def jax_leaves(name, layout):
    return flat(jax_trainer(name, layout).state.params)


def jax_scores(name, layout, batch):
    return np.asarray(jax_trainer(name, layout).make_serving_fn()(batch))


@pytest.mark.parametrize("mode", ["pointwise", "candidates"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(MODELS))
def test_scores_match_jax(name, layout, mode):
    leaves = jax_leaves(name, layout)
    rng = np.random.default_rng(1)
    batch = make_batch(rng, candidates=None if mode == "pointwise" else N, label=None)
    want = jax_scores(name, layout, batch)
    model = params_from_jax(leaves, port_model(name, **LAYOUTS[layout][0]))
    got = TorchTrainer(model, device="cpu").make_serving_fn()(batch)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.isfinite(want).all() and float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_targets_follow_the_jax_model(name):
    """Point-wise rows take the label; candidate rows one-hot-first for the
    factorization models and the label for the sequence models."""
    leaves = jax_leaves(name, "f32")
    params = as_tree(leaves)
    model = params_from_jax(leaves, port_model(name))
    for kwargs in (dict(label="binary"), dict(candidates=N, label="pair")):
        batch = make_batch(np.random.default_rng(2), **kwargs)
        _, want = jax_model(name).apply({"params": params}, batch, train=False)
        with torch.no_grad():
            _, got = model({k: torch.as_tensor(v) for k, v in batch.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- units ---------------------------------------------------------------


def test_masked_gru_matches_jax_with_empty_and_full_rows():
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 0.5, (6, S, E)).astype(np.float32)
    lengths = np.array([0, S, 3, 1, S - 1, 0], np.int32)
    jax_gru = JaxMaskedGRU(hidden_size=H)
    variables = jax_gru.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths))
    leaves = flat(variables["params"])

    def jax_loss(params, xs):
        h = jax_gru.apply({"params": params}, xs, jnp.asarray(lengths))
        return jnp.sum(jnp.sin(h)), h

    (_, want), (gp, gx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    gru = MaskedGRU(E, H, device="cpu", generator=torch.Generator().manual_seed(0))
    bound = 1.0 / H ** 0.5
    assert all(float(p.abs().max()) <= bound for p in gru.parameters())  # torch's GRU init
    holder = torch.nn.Module()
    holder.rnn = gru
    params_from_jax({f"rnn/{k}": v for k, v in leaves.items()}, holder)
    assert tuple(gru.w_ih.shape) == (E, 3 * H) and tuple(gru.w_hh.shape) == (H, 3 * H)
    xt = torch.from_numpy(x).requires_grad_()
    got = gru(xt, torch.from_numpy(lengths))
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    assert not got[0].any() and not got[5].any()  # length 0: the zero state
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-6)
    assert not xt.grad[2, 3:].any()  # steps past a row's length take no gradient
    for key, value in flat(gp).items():
        np.testing.assert_allclose(getattr(gru, key).grad.numpy(), value, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_attention_subtracts_one_global_max():
    """Row maxima more than 20 under the global max: the same weights and
    gradients as JAX's."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 4, 6)).astype(np.float32)
    k = rng.normal(size=(3, 4, 6)).astype(np.float32)
    q[1] *= np.float32(5.0)
    k[1] *= np.float32(6.0)
    mask = (rng.random((3, 4, 4)) < 0.3).astype(np.int32)
    mask[..., 0] = 0  # key 0 always valid
    scale = 6 ** -0.5

    def jax_out(qq, kk):
        return jax_attention.scaled_dot_product_attention(qq, kk, kk, scale=scale,
                                                          attn_mask=jnp.asarray(mask))

    want = np.asarray(jax_out(jnp.asarray(q), jnp.asarray(k)))
    qt, kt = torch.from_numpy(q).requires_grad_(), torch.from_numpy(k).requires_grad_()
    got = scaled_dot_product_attention(qt, kt, kt, scale=scale, attn_mask=torch.from_numpy(mask))
    scores = np.einsum("bqd,bkd->bqk", q, k) * scale
    assert (scores.max() - scores.max(axis=-1)).max() > 20.0
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=1e-6)
    _, vjp = jax.vjp(jax_out, jnp.asarray(q), jnp.asarray(k))
    gq, gk = vjp(jnp.ones_like(jnp.asarray(want)))
    got.sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gq), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk), rtol=1e-4, atol=1e-5)


def test_attention_rounds_scores_against_the_global_max():
    """One score of 2**28 (exact, as every product here): every other
    score lies within +-4 of 0, so minus it rounds to -2**28 in f32, and
    each row attends uniformly, in the port as in JAX, where a per-row max
    (torch's own attention) tells the scores apart."""
    rng = np.random.default_rng(9)
    q = rng.integers(-4, 5, size=(3, 4, 4)).astype(np.float32) / np.float32(4.0)
    k = rng.integers(-4, 5, size=(3, 4, 4)).astype(np.float32) / np.float32(4.0)
    q[1, 0], k[1, 0] = np.float32(2.0 ** 14) * np.eye(4, dtype=np.float32)[0], \
        np.float32(2.0 ** 14) * np.eye(4, dtype=np.float32)[0]
    mask = np.zeros((3, 4, 4), np.int32)
    mask[0, :, 3] = 1
    want = np.asarray(jax_attention.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), attn_mask=jnp.asarray(mask)))
    got = scaled_dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(k), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    uniform = np.broadcast_to(k[0, :3].mean(axis=0), (4, 4))
    np.testing.assert_allclose(got[0].numpy(), uniform, rtol=1e-6, atol=1e-7)
    per_row = torch.nn.functional.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
        attn_mask=torch.from_numpy(mask == 0), scale=1.0)
    assert float((per_row[0] - got[0]).abs().max()) > 1e-2


def test_attention_gradient_splits_a_tied_global_max():
    """``torch.amax`` and ``jnp.max`` share a tied max's gradient evenly;
    the gradient through the max is not detached."""
    x = np.array([[[1.0, 3.0], [3.0, 0.5]]], np.float32)  # the max 3.0 twice

    def jax_f(a):
        return jnp.sum((a - jnp.max(a)) ** 2)

    want = np.asarray(jax.grad(jax_f)(jnp.asarray(x)))
    a = torch.from_numpy(x).requires_grad_()
    torch.sum((a - torch.amax(a)) ** 2).backward()
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("shared", [True, False])
def test_sasrec_encoder_matches_jax(shared):
    name = "sasrec" if shared else "sasrec_layers"
    leaves = jax_leaves(name, "f32")
    model = params_from_jax(leaves, port_model(name))
    prefix = "block_shared" if shared else "block_1"
    block = getattr(model, prefix)
    assert isinstance(block, SASRecBlock) and block.LayerNorm_0.bias.shape == (E,)
    assert len({id(b) for b in model.blocks}) == (1 if shared else 2)
    keys = set(model.state_dict())
    assert (f"{prefix}.Q.weight" in keys and f"{prefix}.Q.bias" not in keys
            and f"{prefix}.W1.bias" in keys and not any(k.startswith("blocks.") for k in keys))
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 0.3, (BATCH, S, E)).astype(np.float32)
    his, lengths = _history(rng, BATCH)
    valid = (his > 0).astype(np.int32)
    valid[:, 0] = 1
    jax_blocks = [jax_attention.SASRecBlock(emb_size=E) for _ in range(2)]
    names = [prefix, prefix] if shared else ["block_0", "block_1"]
    x_j = jnp.asarray(x)
    mask = 1 - jnp.broadcast_to(jnp.asarray(valid)[:, None, :], (BATCH, S, S))
    params = as_tree(leaves)
    for blk, block_name in zip(jax_blocks, names):
        x_j = blk.apply({"params": params[block_name]}, x_j, mask)
    want = jnp.sum(x_j * jnp.asarray(valid)[..., None], axis=1) / jnp.asarray(lengths)[:, None]
    with torch.no_grad():
        got = sasrec_encoder(torch.from_numpy(x), torch.from_numpy(valid),
                             torch.from_numpy(lengths), model.blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


def test_svdpp_empty_implicit_history_is_nan_where_jax_is():
    leaves = jax_leaves("svdpp", "f32")
    batch = make_batch(np.random.default_rng(6), candidates=N, label=None)
    batch["imp"][[2, 7]] = 0  # no implicit id at all
    want = jax_scores("svdpp", "f32", batch)
    model = params_from_jax(leaves, port_model("svdpp"))
    got = TorchTrainer(model, device="cpu").make_serving_fn()(batch).numpy()
    assert np.isnan(want[[2, 7]]).all() and np.isfinite(np.delete(want, [2, 7], axis=0)).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["ncf", "sasrec"])
def test_dropout_masks_come_from_the_trainer_generator(name):
    """With dropout 0.5, ``train_step``'s loss is the loss of the model
    called in training mode with a generator in the trainer's state, bit
    for bit, and it consumes the same draws; the serving call drops
    nothing."""
    model = port_model(name, dropout=0.5)
    trainer = TorchTrainer(model, device="cpu")
    trainer.compile(optimizer="adam", lr=1e-3, loss="bce")
    batch = make_batch(np.random.default_rng(7), candidates=2, label="pair")
    trainer.init_state(batch, seed=3)
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    generator = torch.Generator().set_state(trainer.state.rng.get_state())
    with torch.no_grad():
        prediction, target = model(tensors, train=True, generator=generator)
        want = trainer.loss_fn(prediction, target)
        serving, _ = model(tensors)
        assert not torch.equal(prediction, serving)  # masks were drawn
        assert torch.equal(serving, model(tensors)[0])
    got = trainer.train_step(batch)
    assert torch.equal(got, want)
    assert torch.equal(generator.get_state(), trainer.state.rng.get_state())


def test_init_matches_the_flax_initialisers():
    """``init_state`` draws the masked GRU uniform, LayerNorm ones and
    zeros, SVD++'s ``global_bias`` 0 and every other weight normal(0, 0.01),
    as the JAX package's initialisers."""
    cases = {"gru4rec": "rnn.", "sasrec": "LayerNorm_0", "svdpp": "global_bias"}
    for name, special in cases.items():
        model = port_model(name)
        trainer = TorchTrainer(model, device="cpu")
        trainer.compile()
        trainer.init_state(make_batch(np.random.default_rng(8), candidates=2), seed=1)
        for key, value in model.state_dict().items():
            if key.startswith("rnn."):
                assert 0.2 < float(value.abs().max()) <= 1.0 / H ** 0.5, key
            elif "LayerNorm_0.scale" in key:
                assert torch.equal(value, torch.ones_like(value)), key
            elif "LayerNorm_0.bias" in key or key == "global_bias":
                assert not value.any(), key
            else:
                assert 0.005 < float(value.std()) < 0.02, key
        assert any(special in key for key in model.state_dict())
