"""The int8 training path on the card: the requantize kernel against its
plain version, and two int8 train steps on the card against the CPU.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_requantize_gpu.py

Tolerances: requantized rows' scale and accumulator rtol 3e-7 and q bytes
identical except on a row whose scale or accumulator differs, by at most
one (the kernel sums g^2 in the plain version's order, so they should agree
bit for bit); two train steps card against CPU: losses rtol 1e-5, dense
parameters rtol 1e-4 / atol 1e-6, touched rows' scale and accumulator rtol
1e-4 / atol 1e-6, q values off by one in at most 0.1% of them (f32 sums in
another order).
"""

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.ops.kernels.quantize import (
    quantize_rows,
    requantize_rows,
    requantize_rows_plain,
)
from pytorchrec_tpu_torch.ops.quantized_packed import pack_quantized_table, unpack_quantized_table
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer

SALT = 0x5EED1234


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rows_agree(got: torch.Tensor, want: torch.Tensor, e: int) -> None:
    gq, gs, ga = unpack_quantized_table(got.cpu(), e)
    wq, ws, wa = unpack_quantized_table(want.cpu(), e)
    torch.testing.assert_close(gs, ws, rtol=3e-7, atol=0.0)
    torch.testing.assert_close(ga, wa, rtol=3e-7, atol=0.0)
    diff = (gq.int() - wq.int()).abs()
    same_row = (gs == ws) & (ga == wa)
    assert int((diff * same_row[:, None]).max()) == 0 and int(diff.max()) <= 1
    assert not got[:, e + 8:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,w,lr", [(1, 16, 128, 0.01), (1000, 16, 128, 0.01),
                                      (851_968, 16, 128, 1e-3), (1000, 16, 128, 10.0),
                                      (777, 37, 256, 0.01), (333, 4, 64, 0.1)])
def test_requantize_kernel_matches_plain(n, e, w, lr):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + e)
    rows = torch.randn((n, e), device="cuda", generator=gen) * 0.01
    rows[n // 2] = 0.0
    q, scale = quantize_rows(rows)
    acc = torch.rand((n,), device="cuda", generator=gen) * 1e-3
    moved = pack_quantized_table(q, scale, acc, e, min_width=w)
    moved[:, e + 8:] = 0x5A  # stale staging bytes must not leak into the output
    g = torch.randn((n, e), device="cuda", generator=gen)
    g[n // 2] = 0.0
    ids = (2**31 - 1 - torch.randint(0, 10**6, (n,), device="cuda", generator=gen)).int()
    before = requantize_rows.launches
    got = requantize_rows(moved, g, ids, SALT, lr, e)
    torch.cuda.synchronize()
    assert requantize_rows.launches == before + 1
    _rows_agree(got, requantize_rows_plain(moved, g, ids, SALT, lr, e), e)
    if n > 1:
        _, new_scale, _ = unpack_quantized_table(got[n // 2:n // 2 + 1].cpu(), e)
        assert float(new_scale[0]) == 1.0


def _model(device):
    return DCNv2(sparse_columns=[tfc.CategoricalColumnWithIdentity(f"c_{i}", 1000)
                                 for i in range(4)],
                 dense_columns=[tfc.NumericColumn(f"d_{i}") for i in range(3)],
                 label_column=tfc.CategoricalColumnWithIdentity("label", 2), emb_size=16,
                 num_cross_layers=2, layers=(32, 16), unified_embedding=True,
                 quantized_embedding=True, table_packed=True, device=device,
                 generator=torch.Generator(device=device).manual_seed(0))


@pytest.mark.gpu
def test_two_int8_steps_on_the_card_match_the_cpu():
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        batch = {f"c_{i}": rng.integers(0, 1000, 512).astype(np.int32) for i in range(4)}
        batch.update({f"d_{i}": rng.normal(size=512).astype(np.float32) for i in range(3)})
        batch["label"] = rng.integers(0, 2, 512).astype(np.int32)
        batches.append(batch)
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = QuantizedEmbeddingTrainer(_model(device), device=device, packed_tables=True)
        trainer.compile(optimizer="adam", lr=1e-2, loss="bce")
        trainer.init_state(batches[0], seed=0)
        if device == "cpu":  # the card's initial state (in place), so only the steps differ
            trainer.model.load_state_dict(start)
        else:
            start = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        losses = torch.stack([trainer.train_step(b) for b in batches]).cpu()
        runs[device] = losses, {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    (card_loss, card), (cpu_loss, cpu) = runs["cuda"], runs["cpu"]
    torch.testing.assert_close(card_loss, cpu_loss, rtol=1e-5, atol=0.0)
    for key in cpu:
        if key != "unified_q":
            torch.testing.assert_close(card[key], cpu[key], rtol=1e-4, atol=1e-6)
    touched = torch.from_numpy(np.unique(np.concatenate(
        [b[f"c_{i}"] + 1000 * i for b in batches for i in range(4)])))
    (cq, cs, ca), (pq, ps, pa) = (unpack_quantized_table(t["unified_q"][touched], 16)
                                  for t in (card, cpu))
    torch.testing.assert_close(cs, ps, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(ca, pa, rtol=1e-4, atol=1e-6)
    diff = (cq.int() - pq.int()).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= max(1, diff.numel() // 1000)
