"""The captured train step on the card: ``fit_steps`` replaying CUDA graphs
against eager ``train_step``s, and B3 and B8 reading their salt from a
device word across replays of one graph.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_capture_gpu.py

A small DCN-v2 (3 sparse fields of vocab 1000, E=8, 2 dense fields, 2 cross
layers, MLP (16,)) trains 14 steps of 256-row batches from one seed twice:
14 eager ``train_step``s, and ``fit_steps(7, steps_per_call=1)`` then
``fit_steps(7, steps_per_call=3)`` (a tail call of 1). The two runs do the
same operations on the same values in the same order, so every loss, every
dense parameter and every table byte must be equal, bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.ops.kernels.quantize import (
    requantize_rows,
    requantize_rows_plain,
    salt_word,
    stochastic_quantize_rows,
    stochastic_quantize_rows_keyed_plain,
)
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.ops.quantized_packed import pack_quantized_table
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer, SparseEmbeddingTrainer

VOCAB, N_SPARSE, N_DENSE, BATCH, E = 1000, 3, 2, 256, 8
KERNELS = (cross_network, segmented_sum_scan, requantize_rows, scatter_set_rows,
           stochastic_quantize_rows)
FORMATS = {"f32": dict(unified_embedding=True),
           "int8": dict(unified_embedding=True, quantized_embedding=True, table_packed=True),
           "classic": dict(unified_embedding=True, quantized_embedding=True)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {f"c_{i}": np.minimum(rng.zipf(1.3, BATCH) - 1, VOCAB - 1).astype(np.int64)
                 for i in range(N_SPARSE)}
        batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32)
                      for i in range(N_DENSE)})
        batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
        out.append(batch)
    return out


def _trainer(table, batch, dropout=0.0, loss="bce"):
    model = DCNv2(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2),
        emb_size=E, num_cross_layers=2, layers=(16,), dropout=dropout, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0), **FORMATS[table])
    if table == "f32":
        trainer = SparseEmbeddingTrainer(model, packed_tables=True)
    else:
        trainer = QuantizedEmbeddingTrainer(model, packed_tables=table == "int8")
    trainer.compile(optimizer="adam", lr=1e-2, loss=loss)
    trainer.init_state(batch, seed=0)
    return trainer


def _state(trainer):
    out = {f"param {k}": v.detach().clone() for k, v in trainer.model.state_dict().items()}
    out.update({f"packed {k}": v.clone() for k, v in trainer.state.packed.items()})
    out.update({f"acc {k}": v.clone()
                for k, v in getattr(trainer.state, "table_acc", {}).items()})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["f32", "int8", "classic"])
def test_captured_steps_equal_eager_steps(table):
    _need_card()
    batches = _batches(14)
    eager, captured = _trainer(table, batches[0]), _trainer(table, batches[0])
    losses = torch.stack([eager.train_step(b) for b in batches])
    captured.fit_steps(iter(batches[:7]), steps=7, log_every=7, steps_per_call=1)
    first = captured.step_losses.clone()
    history = captured.fit_steps(iter(batches[7:]), steps=7, log_every=3, steps_per_call=3)
    torch.cuda.synchronize()
    assert sorted(captured._graphs) == [1, 3]  # the tail call replays the 1-step graph
    assert captured.state.step == eager.state.step == 14
    assert torch.equal(torch.cat([first, captured.step_losses]), losses)
    assert history.history["loss"] == [float(losses[9]), float(losses[12]), float(losses[13])]
    want = _state(eager)
    for key, got in _state(captured).items():
        assert torch.equal(got, want[key]), key


@pytest.mark.gpu
def test_unpacked_batches_are_captured_too():
    """``packed_transfer=False``: each batch key has its own static buffer,
    one step a replay, bit-equal to the eager steps."""
    _need_card()
    batches = _batches(5)
    eager, captured = _trainer("f32", batches[0]), _trainer("f32", batches[0])
    captured.packed_transfer = False
    losses = torch.stack([eager.train_step(b) for b in batches])
    captured.fit_steps(iter(batches), steps=5, log_every=5)
    assert sorted(captured._graphs) == [1] and captured._packer is None
    assert torch.equal(captured.step_losses, losses)
    want = _state(eager)
    for key, got in _state(captured).items():
        assert torch.equal(got, want[key]), key


@pytest.mark.gpu
def test_launches_per_replay_equal_the_eager_step():
    _need_card()
    batches = _batches(8)
    trainer = _trainer("int8", batches[0])
    before = {k: k.launches for k in KERNELS}
    trainer.train_step(batches[0])
    per_step = {k: k.launches - before[k] for k in KERNELS}
    assert per_step[requantize_rows] == 1 and per_step[cross_network] == 1
    trainer.fit_steps(iter(batches[:4]), steps=4, steps_per_call=1)  # warm-up, then graphs
    before = {k: k.launches for k in KERNELS}
    trainer.fit_steps(iter(batches), steps=8, steps_per_call=4)  # two replays of 4 steps
    assert {k: k.launches - before[k] for k in KERNELS} == {k: 8 * n for k, n in per_step.items()}
    assert trainer._graphs[4].tally == {k: 4 * n for k, n in per_step.items() if n}


@pytest.mark.gpu
def test_the_salt_is_read_from_a_device_word_at_each_replay():
    """B3 and B8 captured once, replayed at two salts: each replay bit-equal
    to the plain version at the salt the word held."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, e, w = 5000, 16, 128
    rows = torch.randn((n, e), device="cuda", generator=gen) * 0.01
    ids = torch.randint(0, 2**31 - 1, (n,), device="cuda", generator=gen, dtype=torch.int32)
    q, scale = stochastic_quantize_rows(rows, ids=ids, salt=1)
    moved = pack_quantized_table(q, scale, torch.rand((n,), device="cuda", generator=gen) * 1e-3,
                                 e)
    moved = torch.nn.functional.pad(moved, (0, w - moved.shape[1]))
    g = torch.randn((n, e), device="cuda", generator=gen) * 1e-3
    word = salt_word(0, "cuda")
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm up on the capture stream
        requantize_rows(moved, g, ids, word, 0.01, e)
        stochastic_quantize_rows(rows, ids=ids, salt=word)
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph, stream=stream):
        out_rows = requantize_rows(moved, g, ids, word, 0.01, e)
        out_q, out_scale = stochastic_quantize_rows(rows, ids=ids, salt=word)
    for salt in (0x9E3779B9, 0x1234567):
        word.copy_(salt_word(salt, "cuda"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_rows, requantize_rows_plain(moved, g, ids, salt, 0.01, e))
        want_q, want_scale = stochastic_quantize_rows_keyed_plain(rows, ids, salt)
        assert torch.equal(out_q, want_q) and torch.equal(out_scale, want_scale)


@pytest.mark.gpu
def test_dropout_replays_draw_the_eager_masks():
    """Dropout 0.5: each replay draws fresh masks from the registered
    generator, the same ones the eager steps draw."""
    _need_card()
    batches = _batches(6)
    eager, captured = (_trainer("f32", batches[0], dropout=0.5) for _ in range(2))
    losses = torch.stack([eager.train_step(b) for b in batches])
    captured.fit_steps(iter(batches), steps=6, steps_per_call=2)
    assert torch.equal(captured.step_losses, losses)
    assert len(set(losses.tolist())) == 6
    want = _state(eager)
    for key, got in _state(captured).items():
        assert torch.equal(got, want[key]), key


_FAILING_CAPTURE = """
import sys
import torch
sys.path.insert(0, {tests!r})
from test_torch_capture_gpu import _batches, _trainer
from pytorchrec_tpu_torch.loss import get_loss

bce = get_loss("bce")


def syncing_bce(prediction, target):
    loss = bce(prediction, target)
    return loss * (1.0 if loss.item() >= 0 else 0.0)  # a host sync


batches = _batches(3)
trainer = _trainer("f32", batches[0], loss=syncing_bce)
try:
    trainer.fit_steps(iter(batches), steps=3, steps_per_call=1)
except RuntimeError as error:
    assert trainer.state.step == 1, trainer.state.step  # the warm-up; no step in its place
    assert not trainer._graphs
    print("raised:", str(error).splitlines()[0])
else:
    raise SystemExit("the capture did not raise")
"""


@pytest.mark.gpu
def test_a_capture_that_fails_raises():
    """A loss that syncs with the host cannot be captured: fit_steps raises
    after the warm-up step and runs no step eagerly in its place. In a
    process of its own: PyTorch leaves the generators a failed capture
    registered (its default CUDA generator among them) in capture mode, so
    nothing after it in the process could draw from them."""
    _need_card()
    tests = str(Path(__file__).resolve().parent)
    run = subprocess.run([sys.executable, "-c", _FAILING_CAPTURE.format(tests=tests)],
                         cwd=Path(tests).parent, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "raised:" in run.stdout, run.stdout + run.stderr
