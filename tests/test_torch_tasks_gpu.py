"""The multi-task family and the new optimizers on the card.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_tasks_gpu.py

* An MMoE (3 sparse fields of vocab 1000 on a unified table, E=8, 2 dense
  fields, 4 experts of (32, 16), towers (8,)) scores and takes its
  gradients on the card and on the CPU from the same weights: predictions
  and every gradient rtol 1e-4 / atol 1e-6 (f32 sums in another order).
* ``adagrad``, ``adamw`` (weight decay 1e-4) and ``adam`` with
  ``grad_clip_norm=1.0`` under ``Trainer`` on a small DCN-v2 (per-field
  tables, the dense trainer: every parameter goes through the optimizer):
  8 eager ``train_step``s against ``fit_steps(4, steps_per_call=1)`` then
  ``fit_steps(4, steps_per_call=4)`` from the same state. The two runs do
  the same operations on the same values in the same order, so every loss
  and every parameter and optimizer value must be equal, bit for bit.
"""

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2, MMoE
from pytorchrec_tpu_torch.training import Trainer

VOCAB, N_SPARSE, N_DENSE, BATCH, E = 1000, 3, 2, 256, 8
OPTIMIZERS = {"adagrad": {}, "adamw": dict(weight_decay=1e-4),
              "adam_clip": dict(grad_clip_norm=1.0)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _columns():
    label = tfc.CategoricalColumnWithIdentity(feature_name="label", category_num=2)
    return dict(
        sparse_columns=[tfc.CategoricalColumnWithIdentity(feature_name=f"c_{i}",
                                                          category_num=VOCAB)
                        for i in range(N_SPARSE)],
        dense_columns=[tfc.NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)],
        label_column=label)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {f"c_{i}": np.minimum(rng.zipf(1.3, BATCH) - 1, VOCAB - 1).astype(np.int64)
                 for i in range(N_SPARSE)}
        batch.update({f"d_{i}": rng.normal(size=BATCH).astype(np.float32)
                      for i in range(N_DENSE)})
        batch["label"] = rng.integers(0, 2, BATCH).astype(np.int32)
        batch["conversion"] = (batch["label"] * rng.integers(0, 2, BATCH)).astype(np.int32)
        out.append(batch)
    return out


@pytest.mark.gpu
def test_mmoe_forward_and_backward_card_against_cpu():
    _need_card()
    columns = _columns()
    task_columns = (columns["label_column"],
                    tfc.CategoricalColumnWithIdentity(feature_name="conversion", category_num=2))
    models = {device: MMoE(**columns, task_columns=task_columns, emb_size=E,
                           unified_embedding=True, n_experts=4, expert_layers=(32, 16),
                           tower_layers=(8,), device=device) for device in ("cpu", "cuda")}
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    batch = _batches(1)[0]
    out = {}
    for device, model in models.items():
        prediction, target = model({k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                                   train=True)
        torch.nn.functional.binary_cross_entropy_with_logits(prediction, target).backward()
        out[device] = (prediction.detach().cpu(),
                       {n: p.grad.cpu() for n, p in model.named_parameters()})
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-6)
    for name, grad in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][name], grad, rtol=1e-4, atol=1e-6,
                                   msg=lambda m, n=name: f"{n}: {m}")


def _trainer(name):
    model = DCNv2(**_columns(), emb_size=E, num_cross_layers=2, layers=(16,), device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, device="cuda")
    trainer.compile(optimizer=name.split("_")[0], lr=1e-2, loss="bce", metrics=(),
                    **OPTIMIZERS[name])
    trainer.init_state(_batches(1)[0], seed=0)
    return trainer


def _state(trainer):
    out = {f"param {k}": v.detach().clone() for k, v in trainer.model.state_dict().items()}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for param, entry in trainer.state.optimizer.state.items():
        out.update({f"opt {names[id(param)]} {k}": v.clone() for k, v in entry.items()})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_new_optimizers_captured_equal_eager(name):
    _need_card()
    batches = _batches(8, seed=1)
    eager, captured = _trainer(name), _trainer(name)
    losses = torch.stack([eager.train_step(b) for b in batches])
    captured.fit_steps(iter(batches[:4]), steps=4, steps_per_call=1)
    first = captured.step_losses.clone()
    captured.fit_steps(iter(batches[4:]), steps=4, steps_per_call=4)
    assert any(layout.graphs for layout in captured._layouts.values())
    assert torch.equal(torch.cat([first, captured.step_losses]), losses)
    got, want = _state(captured), _state(eager)
    assert list(got) == list(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
