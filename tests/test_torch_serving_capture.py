"""The scorer's static buffers on the CPU (``utils/graphs.py``): the
keying, the copy-out and the packing that CUDA graphs rely on on the card,
where the same body is captured and replayed.

A small DCN-v2 (3 sparse fields of vocab 50, E=4, 2 dense fields, 2 cross
layers, MLP (8,)) and a small two-tower model (E=8, towers (16, 8), cosine),
both with random weights from a seed, score through
``Trainer.make_serving_fn()``, ``Trainer.evaluate`` and ``make_retrieve_fn``.
On the CPU every request runs the body eagerly over the static inputs of its
signature, so each result must equal the eager model call's bit for bit.
"""

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2, TwoTower
from pytorchrec_tpu_torch.ops import kernels
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.ops.kernels.retrieval_topk import bin_max_scores
from pytorchrec_tpu_torch.serving import build_item_index, make_retrieve_fn
from pytorchrec_tpu_torch.training import SparseEmbeddingTrainer, Trainer
from pytorchrec_tpu_torch.training.trainer import request_signature
from pytorchrec_tpu_torch.utils.graphs import GraphCache, StaticInputs

VOCAB, N_SPARSE, N_DENSE = 50, 3, 2
USERS, ITEMS = 40, 300


def _dcn(unified=False):
    return DCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        emb_size=4, num_cross_layers=2, layers=(8,), unified_embedding=unified, device="cpu",
        generator=torch.Generator().manual_seed(0))


def _batch(rng, rows, label=True):
    batch = {f"c_{i}": rng.integers(0, VOCAB, rows).astype(np.int64) for i in range(N_SPARSE)}
    batch.update({f"d_{i}": rng.normal(size=rows).astype(np.float32) for i in range(N_DENSE)})
    if label:
        batch["label"] = rng.integers(0, 2, rows).astype(np.int32)
    return batch


def _spread(model, seed=0):
    """Weights N(0, 1) so that scores differ visibly between requests."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for param in model.parameters():
            param.copy_(torch.randn(param.shape, generator=gen))
    return model


def test_a_second_request_leaves_the_first_result_alone():
    rng = np.random.default_rng(0)
    serve = Trainer(_spread(_dcn()), device="cpu").make_serving_fn()
    first, second = _batch(rng, 16, label=False), _batch(rng, 16, label=False)
    a = serve(first)
    kept = a.clone()
    b = serve(second)
    assert torch.equal(a, kept) and not torch.equal(a, b)
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, serve.eager(first)) and torch.equal(b, serve.eager(second))
    assert torch.equal(serve(first), a)


def test_each_request_signature_gets_its_own_static_inputs():
    rng = np.random.default_rng(1)
    trainer = Trainer(_spread(_dcn()), device="cpu")
    serve = trainer.make_serving_fn()
    requests = [_batch(rng, 16, label=False), _batch(rng, 16, label=False),
                _batch(rng, 5, label=False), _batch(rng, 16)]
    for req in requests:
        serve(req)
    # the two 16-row requests share one signature; 5 rows and the label add two
    assert len(trainer._scores) == 3
    sigs = [request_signature(r) for r in requests]
    assert sigs[0] == sigs[1] and len(set(sigs)) == 3
    big, small = (trainer._scores.inputs(s) for s in sigs[1:3])
    assert big is not small and big.buffers[0].numel() != small.buffers[0].numel()
    # the static inputs hold the last request of their signature, packed
    np.testing.assert_array_equal(big.batch["c_1"].numpy(), requests[1]["c_1"])
    assert big.batch["c_1"].dtype == torch.int32 and len(big.buffers) == 2  # ints, floats
    # int32 ids are another signature, with the same packed layout
    as_int32 = {k: v.astype(np.int32) if v.dtype == np.int64 else v
                for k, v in requests[0].items()}
    assert request_signature(as_int32) != sigs[0]
    assert torch.equal(serve(as_int32), serve(requests[0]))


def test_a_labelled_batch_and_an_unlabelled_one_differ():
    rng = np.random.default_rng(2)
    trainer = Trainer(_spread(_dcn()), device="cpu")
    labelled = _batch(rng, 8)
    bare = {k: v for k, v in labelled.items() if k != "label"}
    prediction, target = trainer._eval_step(labelled)
    assert torch.equal(target, torch.from_numpy(labelled["label"]).float())
    assert torch.equal(trainer.make_serving_fn()(bare), prediction)
    assert trainer._eval_step(bare)[1] is None
    assert len(trainer._scores) == 2
    # the target is copied out too: the next labelled batch leaves it alone
    kept = target.clone()
    trainer._eval_step(_batch(rng, 8))
    assert torch.equal(target, kept)


def test_unpacked_inputs_hold_one_buffer_a_key():
    rng = np.random.default_rng(3)
    trainer = Trainer(_spread(_dcn()), device="cpu", packed_transfer=False)
    req = _batch(rng, 8, label=False)
    got = trainer.make_serving_fn()(req)
    inputs = trainer._scores.inputs(request_signature(req))
    assert len(inputs.buffers) == len(req) and inputs.batch["c_0"].dtype == torch.int64
    assert torch.equal(got, trainer.make_serving_fn().eager(req))


def test_init_state_and_a_new_layout_drop_the_graphs():
    """``init_state`` drops the scorer's graphs. A new training layout no
    longer does: the trainer keeps a layout's steps a layout each, and the
    scorer's graphs read the tables and weights that every layout's steps
    update in place, so they score the current state after it."""
    rng = np.random.default_rng(4)
    trainer = SparseEmbeddingTrainer(_dcn(unified=True), device="cpu", packed_tables=True)
    trainer.compile(optimizer="adam", lr=1e-2, loss="bce", metrics=())
    batch = _batch(rng, 16)
    trainer.init_state(batch, seed=0)
    serve = trainer.make_serving_fn()
    bare = {k: v for k, v in batch.items() if k != "label"}
    before = serve(bare)
    assert len(trainer._scores) == 1
    trainer.train_step(batch)  # the tables and weights move in place
    after = serve(bare)
    assert not torch.equal(before, after) and torch.equal(after, serve.eager(bare))
    trainer.fit_steps(iter([_batch(rng, 32)]), steps=1)  # a new training layout
    assert len(trainer._scores) == 1
    moved = serve(bare)
    assert not torch.equal(moved, after) and torch.equal(moved, serve.eager(bare))
    trainer.init_state(batch, seed=1)
    assert len(trainer._scores) == 0


def _two_tower():
    col = tfc.CategoricalColumnWithIdentity
    model = TwoTower(uid_column=col(feature_name="uid", category_num=USERS),
                     iid_column=col(feature_name="iid", category_num=ITEMS),
                     label_column=col(feature_name="label", category_num=2), emb_size=8,
                     layers=(16, 8), normalize=True, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    return _spread(model, seed=5)


@pytest.mark.parametrize("approx", [False, "fused"])
def test_retrieve_answers_from_the_index_it_is_given(approx):
    model = _two_tower()
    index = build_item_index(model, ITEMS, batch_size=64, dtype=torch.float32)
    other = index.flip(0).contiguous()  # item i of ``other`` is item ITEMS - 1 - i
    retrieve = make_retrieve_fn(model, approx=approx, chunk_items=128)
    u_ids = np.arange(6, dtype=np.int32)
    scores, ids = retrieve(index, u_ids, 5)
    other_scores, other_ids = retrieve(other, u_ids, 5)
    assert len(retrieve.graphs) == 2  # one a (index, B, k)
    assert torch.equal(other_scores, scores)
    assert torch.equal(other_ids, ITEMS - 1 - ids)
    for got, want in zip(retrieve(index, u_ids, 5), retrieve.eager(index, u_ids, 5)):
        assert torch.equal(got, want)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (6, 5)
    retrieve(index, u_ids[:3], 5)
    retrieve(index, u_ids, 7)
    assert len(retrieve.graphs) == 4
    retrieve.graphs.clear()
    assert len(retrieve.graphs) == 0


def test_launch_counts_equal_the_eager_body():
    """On the CPU the kernels' plain versions run and count nothing, in the
    scorer as eagerly; a body's own ``count_launch`` counts once a call, as
    each replay's tally adds on the card."""
    rng = np.random.default_rng(6)
    serve = Trainer(_spread(_dcn()), device="cpu").make_serving_fn()
    model = _two_tower()
    index = build_item_index(model, ITEMS, batch_size=64)
    retrieve = make_retrieve_fn(model, approx="fused")
    req = _batch(rng, 8, label=False)
    before = (cross_network.launches, bin_max_scores.launches)
    for _ in range(3):
        serve(req)
        serve.eager(req)
        retrieve(index, np.arange(4), 3)
    assert (cross_network.launches, bin_max_scores.launches) == before

    def counted():
        pass

    counted.launches = 0
    cache = GraphCache("cpu")

    def body(inputs):
        kernels.count_launch(counted)
        return (inputs.buffers[0] * 2,)

    def make():
        return StaticInputs([torch.zeros(3)], lambda x, out: out[0].copy_(x))

    for value in (1.0, 2.0, 3.0):
        x = torch.full((3,), value)
        (out,) = cache.run("k", lambda inputs: inputs.load(x, (x,)), make, body)
        assert torch.equal(out, 2 * x)
    assert counted.launches == 3 and cache.graphs() == 0  # no graph on the CPU
