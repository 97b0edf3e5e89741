"""Captured scoring on the card: ``make_serving_fn``, ``evaluate`` and
``make_retrieve_fn`` replaying CUDA graphs against the eager model call.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_serving_capture_gpu.py

Small models with weights N(0, 1) from a seed: DCN-v2 (3 sparse fields of
vocab 1000, E=8, 2 dense fields, 2 cross layers, MLP (16,)) in f32 and with
the packed int8 table, DIN (E=8, attention (16, 8), MLP (16, 8), histories of
6, 10 candidates) and a cosine two-tower model whose towers end at D=12
(a bf16 index the fused kernel's wrapper pads to 16 columns inside the
graph). The same kernels run on the same values in the same order whether a
request runs eagerly or replays, so every result must be equal, bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2, DIN, TwoTower
from pytorchrec_tpu_torch.ops import attention as attention_module
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network, cross_network_plain
from pytorchrec_tpu_torch.ops.kernels.din_attention import (
    din_attention_pool,
    din_attention_pool_plain,
)
from pytorchrec_tpu_torch.ops.kernels.retrieval_topk import bin_max_scores
from pytorchrec_tpu_torch.serving import build_item_index, make_retrieve_fn
from pytorchrec_tpu_torch.training import Trainer

VOCAB, USERS, ITEMS, S, N = 1000, 500, 5000, 6, 10
KERNELS = (cross_network, din_attention_pool, bin_max_scores)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _spread(model, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(torch.randn(param.shape, device="cuda", generator=gen)
                        * (1.0 if "embedding" in name else 0.3))
    return model


def _dcn(table="f32"):
    formats = {"f32": {}, "int8": dict(unified_embedding=True, quantized_embedding=True,
                                       table_packed=True)}
    col = tfc.CategoricalColumnWithIdentity
    return _spread(DCNv2(
        sparse_columns=[col(feature_name=f"c_{i}", category_num=VOCAB) for i in range(3)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(2)],
        label_column=col(feature_name="label", category_num=2), emb_size=8,
        num_cross_layers=2, layers=(16,), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0), **formats[table]))


def _dcn_batch(rng, rows, label=False):
    batch = {f"c_{i}": rng.integers(0, VOCAB, rows).astype(np.int64) for i in range(3)}
    batch.update({f"d_{i}": rng.normal(size=rows).astype(np.float32) for i in range(2)})
    if label:
        batch["label"] = rng.integers(0, 2, rows).astype(np.int32)
    return batch


def _din():
    col = tfc.CategoricalColumnWithIdentity
    return _spread(DIN(uid_column=col(feature_name="uid", category_num=USERS),
                       iid_column=col(feature_name="iid", category_num=ITEMS),
                       his_column=col(feature_name="pos_his", category_num=ITEMS),
                       his_len_column=col(feature_name="pos_his_len", category_num=S + 1),
                       label_column=col(feature_name="label", category_num=2), emb_size=8,
                       att_hidden_units=(16, 8), mlp_layers=(16, 8), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0)))


def _din_batch(rng, rows, candidates=N):
    lengths = rng.integers(0, S + 1, size=rows).astype(np.int32)
    his = rng.integers(1, ITEMS, size=(rows, S)).astype(np.int32)
    his[np.arange(S)[None, :] >= lengths[:, None]] = 0
    shape = rows if candidates is None else (rows, candidates)
    return {"uid": rng.integers(0, USERS, size=rows).astype(np.int32),
            "iid": rng.integers(0, ITEMS, size=shape).astype(np.int32),
            "pos_his": his, "pos_his_len": lengths}


def _counts():
    return {k: k.launches for k in KERNELS}


def _moved(before):
    return {k.__name__: k.launches - n for k, n in before.items() if k.launches != n}


def _serve_twice_each(serve, requests):
    """Every request three times (warm-up, capture and replay, replay), each
    result bit-equal to the eager call's; the launches of each request."""
    launches = []
    for req in requests:
        want = serve.eager(req)
        for _ in range(3):
            before = _counts()
            got = serve(req)
            torch.cuda.synchronize()
            launches.append(_moved(before))
            assert torch.equal(got, want)
    return launches


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["f32", "int8"])
def test_captured_dcnv2_requests_equal_eager(table):
    _need_card()
    rng = np.random.default_rng(0)
    trainer = Trainer(_dcn(table))
    serve = trainer.make_serving_fn()
    requests = [_dcn_batch(rng, rows) for rows in (1, 1000, 4096)]
    launches = _serve_twice_each(serve, requests)
    assert launches == [{"cross_network": 1}] * 9  # eager, then each replay's tally
    assert trainer._scores.graphs() == 3
    # a request already on the card is copied in directly
    on_card = {k: torch.as_tensor(v).cuda() for k, v in requests[1].items()}
    assert torch.equal(serve(on_card), serve.eager(requests[1]))


@pytest.mark.gpu
def test_captured_din_requests_and_evaluation_equal_eager():
    _need_card()
    rng = np.random.default_rng(1)
    trainer = Trainer(_din())
    trainer.compile(metrics=("ndcg@5", "hit@5", "auc"), user_sample_n=N)
    serve = trainer.make_serving_fn()
    requests = [_din_batch(rng, 1, None), _din_batch(rng, 300, None), _din_batch(rng, 64)]
    launches = _serve_twice_each(serve, requests)
    assert launches == [{"din_attention_pool": 1}] * 9

    class Reader:
        split = _din_batch(rng, 100)

        def get_dataset_size(self, split):
            return 100

        def get_batch(self, split, indices):
            return {k: v[indices] for k, v in self.split.items()}

    predictions = trainer.predict(Reader(), batch_size=32)  # 32, 32, 32 and 4 of 32
    want = torch.cat([serve.eager(Reader().get_batch("test", np.arange(s, s + 32)))
                      for s in (0, 32, 64)]).cpu().numpy()
    np.testing.assert_array_equal(predictions[:96], want)
    logs = trainer.evaluate(Reader(), batch_size=32, verbose=0)
    targets = np.zeros_like(predictions)
    targets[:, 0] = 1.0
    assert logs == trainer.metrics(predictions, targets)


@pytest.mark.gpu
@pytest.mark.parametrize("approx", ["fused", False])
def test_captured_retrieval_equals_eager(approx):
    """D = 12: the bf16 index is padded to 16 columns for TMA inside the
    captured wrapper; the padded copy is the graph's own."""
    _need_card()
    col = tfc.CategoricalColumnWithIdentity
    model = _spread(TwoTower(uid_column=col(feature_name="uid", category_num=USERS),
                             iid_column=col(feature_name="iid", category_num=ITEMS),
                             label_column=col(feature_name="label", category_num=2),
                             emb_size=8, layers=(16, 12), normalize=True, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0)))
    index = build_item_index(model, ITEMS)
    assert index.shape[1] % 8 != 0 and index.dtype == torch.bfloat16
    retrieve = make_retrieve_fn(model, approx=approx, chunk_items=2048)
    for b in (1, 37, 256):
        u_ids = np.arange(b, dtype=np.int32) % USERS
        want = retrieve.eager(index, u_ids, 10)
        for _ in range(3):
            before = _counts()
            got = retrieve(index, u_ids, 10)
            torch.cuda.synchronize()
            assert _moved(before) == ({"bin_max_scores": 1} if approx else {})
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert retrieve.graphs.graphs() == 3


@pytest.mark.gpu
def test_plain_checks_under_a_swap_run_no_kernel():
    """A scorer built inside the swap scores its first request eagerly: the
    plain version runs and no kernel counter moves (a graph captured before
    the swap would ignore it)."""
    _need_card()
    rng = np.random.default_rng(2)
    model = _dcn()
    captured = Trainer(model).make_serving_fn()
    req = _dcn_batch(rng, 512)
    for _ in range(3):
        want = captured(req)

    class PlainCross(torch.nn.Module):
        def __init__(self, cross):
            super().__init__()
            self.inner = cross

        def forward(self, x0):
            flat = x0.reshape(-1, self.inner.dim)
            return cross_network_plain(flat, self.inner.ws, self.inner.bs).reshape(x0.shape)

    cross = model.cross
    model.cross = PlainCross(cross)
    try:
        before = _counts()
        plain = Trainer(model).make_serving_fn()(req)
        torch.cuda.synchronize()
        assert _moved(before) == {}
        before = _counts()
        captured(req)  # the old graph still launches the kernel
        torch.cuda.synchronize()
        assert _moved(before) == {"cross_network": 1}
    finally:
        model.cross = cross
    torch.testing.assert_close(plain, want, rtol=1e-4, atol=1e-6)

    din = _din()
    request = _din_batch(rng, 64)
    kernel = Trainer(din).make_serving_fn()(request)
    swapped = attention_module.din_attention_pool
    attention_module.din_attention_pool = din_attention_pool_plain
    try:
        before = _counts()
        plain = Trainer(din).make_serving_fn()(request)
        torch.cuda.synchronize()
        assert _moved(before) == {}
    finally:
        attention_module.din_attention_pool = swapped
    torch.testing.assert_close(plain, kernel, rtol=1e-4, atol=1e-6)


_FAILING_SERVING_CAPTURE = """
import sys
import numpy as np
import torch
sys.path.insert(0, {tests!r})
from test_torch_serving_capture_gpu import _dcn, _dcn_batch
from pytorchrec_tpu_torch.training import Trainer

model = _dcn()
forward = model.forward


def syncing_forward(batch, train=False, generator=None):
    prediction, target = forward(batch, train=train, generator=generator)
    return prediction * (1.0 if prediction.sum().item() == prediction.sum().item() else 0.0), target


model.forward = syncing_forward
trainer = Trainer(model)
serve = trainer.make_serving_fn()
req = _dcn_batch(np.random.default_rng(0), 64)
first = serve(req)  # the warm-up runs eagerly and may sync
try:
    serve(req)
except RuntimeError as error:
    assert trainer._scores.graphs() == 0
    print("raised:", str(error).splitlines()[0])
else:
    raise SystemExit("the capture did not raise")
"""


@pytest.mark.gpu
def test_a_serving_capture_that_fails_raises():
    """A forward that syncs with the host cannot be captured: the second
    request raises, and nothing scores it eagerly in its place. In a process
    of its own, as ``tests/test_torch_capture_gpu.py`` runs its failing
    capture: PyTorch leaves the generators a failed capture registered in
    capture mode."""
    _need_card()
    tests = str(Path(__file__).resolve().parent)
    run = subprocess.run([sys.executable, "-c", _FAILING_SERVING_CAPTURE.format(tests=tests)],
                         cwd=Path(tests).parent, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "raised:" in run.stdout, run.stdout + run.stderr
