"""The streaming Criteo path on the card: the example's twin
(``pytorchrec_tpu_torch/examples/criteo_end_to_end.py``) at a small size.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_streaming_gpu.py

20,000 synthesized raw rows, hash bucket 1,000 (the example's 26 fields,
E=16, D = 429), batches of 512 streamed from the ``.npz`` shards:

* two bf16 trainers from one state: 8 eager ``train_step``s against
  ``fit_steps`` (a warm-up step and replays of a 1-step graph, then replays
  of a 4-step graph over 4-deep inputs) over the same batches, every loss,
  parameter, table and Adam moment bit-equal;
* f32 on the card against f32 on the CPU, 3 steps, each from a common state
  (the card's trainer takes the CPU's parameters, table rows and Adam state
  before each step, as ``chip_smoke.py``'s ``stepped_card_against_cpu``
  does): each loss rtol 1e-5; the dense parameters and the table rows rtol
  1e-4 / atol 1e-6, except values in Adam's eps window (``sqrt(v_hat) <
  1e-6``), held to within two steps of lr; then the held-out batches score
  finite through the card's captured scorer.
"""

import copy
from itertools import islice

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch.examples import criteo_end_to_end as twin
from pytorchrec_tpu_torch.utils.convert import leaves_of, load_leaves

pytestmark = pytest.mark.gpu

ROWS, HASH_BUCKET, BATCH, LR = 20_000, 1000, 512, 1e-3
ADAM_B2, EPS_WINDOW = 0.999, 1e-6


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture()
def data(tmp_path, monkeypatch):
    _need_card()
    monkeypatch.setenv("PYTORCHREC_TPU_WORK_DIR", str(tmp_path))
    return twin.prepare(ROWS, HASH_BUCKET, log=lambda *a: None)


def _state(trainer):
    out = {f"param {k}": v.detach().clone() for k, v in trainer.model.state_dict().items()}
    out.update({f"table {k}": v.clone() for k, v in trainer.state.packed.items()})
    for i, (param, entry) in enumerate(trainer.state.optimizer.state.items()):
        out.update({f"adam {i} {k}": v.clone() for k, v in entry.items()})
    return out


def _trainer(device, precision, sparse):
    return twin.make_trainer(twin.make_model(sparse, device), device, precision)


def test_bf16_captured_steps_equal_eager_steps(data):
    sparse, _, _ = twin.vocab_transform(data["train"], BATCH, 0, HASH_BUCKET)
    host = list(islice(twin.train_source(data, BATCH).batches(), 8))
    eager, captured = (_trainer("cuda", "bfloat16", sparse) for _ in range(2))
    for trainer in (eager, captured):
        trainer.init_state(host[0], seed=3)
    eager_losses = torch.stack([eager.train_step(b) for b in host])
    captured.fit_steps(iter(host[:4]), steps=4, log_every=8)
    first = captured.step_losses.clone()
    captured.fit_steps(iter(host[4:]), steps=4, log_every=8, steps_per_call=4)
    assert sorted(captured._graphs) == [4]  # deeper inputs dropped the 1-step graph
    assert torch.equal(torch.cat([first, captured.step_losses]), eager_losses)
    want, got = _state(eager), _state(captured)
    assert sorted(got) == sorted(want)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ


def _agree(label, got, want, v_hat):
    window = v_hat.sqrt() < EPS_WINDOW
    err = (got - want).abs()
    bad = ~window & (err > 1e-6 + 1e-4 * want.abs())
    assert not bad.any(), f"{label}: {int(bad.sum())} values outside rtol 1e-4 / atol 1e-6"
    assert (err[window] <= 2.01 * LR).all(), f"{label}: a value in the eps window"


def test_f32_card_steps_against_the_cpu_from_a_common_state(data):
    sparse, _, _ = twin.vocab_transform(data["train"], BATCH, 0, HASH_BUCKET)
    host = list(islice(twin.train_source(data, BATCH).batches(), 3))
    card, cpu = _trainer("cuda", None, sparse), _trainer("cpu", None, sparse)
    for trainer in (card, cpu):
        trainer.init_state(host[0], seed=3)
    load_leaves(leaves_of(cpu), card)
    path = next(iter(cpu.state.packed))
    for step, batch in enumerate(host, start=1):
        card_loss, cpu_loss = float(card.train_step(batch)), float(cpu.train_step(batch))
        np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
        bias = 1.0 - ADAM_B2 ** step
        card_params = dict(card.model.named_parameters())
        for name, param in cpu.model.named_parameters():
            if param in cpu.state.optimizer.state:
                _agree(f"step {step} {name}", card_params[name].detach().cpu(), param.detach(),
                       cpu.state.optimizer.state[param]["exp_avg_sq"] / bias)
        ids = np.unique(np.concatenate([batch[f"c_{i}"].astype(np.int64) + i * HASH_BUCKET
                                        for i in range(26)]))
        rows = torch.from_numpy(ids)
        got, want = card.state.packed[path][rows.cuda()].cpu(), cpu.state.packed[path][rows]
        _agree(f"step {step} table", got[:, :16], want[:, :16], want[:, 32:48] / bias)
        with torch.no_grad():  # the next step starts from the CPU's state on both
            card.state.packed[path].copy_(cpu.state.packed[path])
            for name, param in cpu.model.named_parameters():
                card_params[name].copy_(param)
        state = copy.deepcopy(cpu.state.optimizer.state_dict())
        for saved, own in zip(state["param_groups"], card.state.optimizer.param_groups):
            saved.update(fused=own["fused"], foreach=own["foreach"], capturable=own["capturable"])
        card.state.optimizer.load_state_dict(state)
    scores, _ = twin.heldout_scores(card, data, BATCH)
    assert len(scores) == min(twin.HELDOUT_BATCHES, ROWS // 4 // BATCH) * BATCH
    assert np.isfinite(scores).all()
