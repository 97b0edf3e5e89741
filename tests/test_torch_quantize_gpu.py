"""B8 and the classic quantized-row step on the card: the stochastic quantize
kernel against its plain version, the classic step on the card against the
CPU and against the packed step, and the launches a step makes.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_quantize_gpu.py

Tolerances: B8 against plain bit for bit, in both forms (given bits, and
keyed: the kernel's hash against the torch hash), q and scale equal (the
kernel divides and adds as torch does, and a max is exact in any order); two
classic steps card against CPU: losses rtol 1e-5, dense parameters rtol 1e-4
/ atol 1e-6, touched rows' scale and accumulator rtol 1e-4 / atol 1e-6, q
values off by one in at most 0.1% of them (f32 sums in another order); one
classic step against one packed step from the same table on unique ids: q
and scale equal, accumulators rtol 1e-6 (B8 and B3 round alike).
"""

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch import feature_column as tfc
from pytorchrec_tpu_torch.models import DCNv2
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network
from pytorchrec_tpu_torch.ops.kernels.quantize import (
    id_keyed_rounding_bits,
    requantize_rows,
    rounding_bits_i32,
    stochastic_quantize_rows,
    stochastic_quantize_rows_keyed_plain,
    stochastic_quantize_rows_plain,
)
from pytorchrec_tpu_torch.ops.kernels.scatter import scatter_set_rows
from pytorchrec_tpu_torch.ops.kernels.seg_scan import segmented_sum_scan
from pytorchrec_tpu_torch.ops.quantized_packed import pack_quantized_table
from pytorchrec_tpu_torch.training import QuantizedEmbeddingTrainer

KERNELS = (cross_network, segmented_sum_scan, stochastic_quantize_rows, requantize_rows,
           scatter_set_rows)
VOCAB, FIELDS, E = 1000, 4, 16


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _counts():
    return [k.launches for k in KERNELS]


def _quantize_and_compare(rows, bits):
    before = stochastic_quantize_rows.launches
    q, scale = stochastic_quantize_rows(rows, bits)
    torch.cuda.synchronize()
    assert stochastic_quantize_rows.launches == before + 1
    want_q, want_scale = stochastic_quantize_rows_plain(rows, bits)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert torch.equal(q, want_q)
    assert torch.equal(scale.view(torch.int32), want_scale.view(torch.int32))
    return q, scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,e", [(1, 1), (7, 1), (1000, 64), (333, 37), (100, 33), (64, 5),
                                 (851_968, 16)])
def test_b8_matches_plain_bit_for_bit(n, e):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + e)
    rows = torch.randn((n, e), device="cuda", generator=gen) * 0.01
    rows[n // 2] = 0.0  # all zero: scale 1
    ids = torch.randint(0, 2_600_000, (n,), device="cuda", generator=gen)
    bits = rounding_bits_i32(id_keyed_rounding_bits(ids, e, 0x5EED1234))
    assert n * e < 64 or bool((bits < 0).any())  # patterns of 2**31 and above
    q, scale = _quantize_and_compare(rows, bits)
    assert float(scale[n // 2]) == 1.0 and not q[n // 2].any()


def _keyed_and_compare(rows, ids, salt):
    before = stochastic_quantize_rows.launches
    q, scale = stochastic_quantize_rows(rows, ids=ids, salt=salt)
    torch.cuda.synchronize()
    assert stochastic_quantize_rows.launches == before + 1
    want_q, want_scale = stochastic_quantize_rows_keyed_plain(rows, ids, salt)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert torch.equal(q, want_q)
    assert torch.equal(scale.view(torch.int32), want_scale.view(torch.int32))
    return q, scale


@pytest.mark.gpu
@pytest.mark.parametrize("e", [1, 7, 16, 64, 100])
@pytest.mark.parametrize("n", [1, 1000, 851_968])
def test_keyed_b8_matches_keyed_plain_bit_for_bit(n, e):
    """The keyed form (the kernel hashes ids and salt itself) against the
    int64 torch hash and the plain quantization: the words path at E = 16,
    64 and 100, the scalar path at E = 1 and 7; ids up to 2**31 - 1, salts
    of 2**31 and above."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n * 3 + e)
    rows = torch.randn((n, e), device="cuda", generator=gen) * 0.01
    rows[n // 2] = 0.0  # all zero: scale 1
    ids = torch.randint(0, 2**31 - 1, (n,), dtype=torch.int32, device="cuda", generator=gen)
    ids[0] = 2**31 - 1
    for salt in (2**31, 0xFFFFFFFF, 0x1234567):
        q, scale = _keyed_and_compare(rows, ids, salt)
        assert float(scale[n // 2]) == 1.0 and not q[n // 2].any()


@pytest.mark.gpu
def test_keyed_b8_on_unaligned_rows_takes_the_scalar_path():
    """Rows that start 4 bytes past a 16-byte boundary cannot take 16-byte
    loads: the wrapper picks the scalar path, with the same bits."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    wide = torch.randn((1000 * 16 + 1,), device="cuda", generator=gen) * 0.01
    rows = wide[1:].view(1000, 16)
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 4
    ids = torch.arange(1000, dtype=torch.int32, device="cuda") * 2_603
    _keyed_and_compare(rows, ids, 0x9E3779B9)


@pytest.mark.gpu
def test_b8_edge_rows():
    """Quotients that land on integers, bits of 2**31 and above, and values
    that reach 128 and -128 before the clip."""
    _need_card()
    e = 16
    rows = torch.zeros((4, e), device="cuda")
    bits = torch.zeros((4, e), dtype=torch.int32, device="cuda")
    step = 2.0**-7
    rows[0] = (torch.arange(e, device="cuda") + 0.5) * step
    rows[0, -1] = 127 * step
    bits[0] = -2**31  # 0x80000000: u = 1/2, k + 1/2 + 1/2 lands on k + 1
    rows[1, 0] = 127 * step
    bits[1] = -1  # 0xFFFFFFFF: u just under 1, 127 + u rounds to 128
    x = next(v for v in np.linspace(0.5, 1.0, 4001, dtype=np.float32)
             if v / (v / np.float32(127)) > np.float32(127))
    rows[2, 0] = -float(x)  # absmax / scale just over 127: -128 with u = 0
    rows[3] = torch.arange(e, device="cuda") * step - 8 * step
    q, scale = _quantize_and_compare(rows, bits)
    assert q[0, :-1].tolist() == list(range(1, e)) and int(q[0, -1]) == 127
    assert int(q[1, 0]) == 127 and int(q[2, 0]) == -127
    # the keyed form on the same rows: the ids' own bits
    ids = torch.tensor([0, 1, 2**31 - 1, 123_456_789], dtype=torch.int32, device="cuda")
    _keyed_and_compare(rows, ids, 2**31 + 5)


@pytest.mark.gpu
def test_b8_raises_on_what_it_cannot_take():
    _need_card()
    rows = torch.zeros((8, 16), device="cuda")
    bits = torch.zeros((8, 16), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        stochastic_quantize_rows(rows.t(), bits.t())  # not contiguous
    with pytest.raises(ValueError):
        stochastic_quantize_rows(rows, bits.cpu())  # two kinds of device
    ids = torch.zeros((8,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        stochastic_quantize_rows(rows, ids=ids.cpu(), salt=1)  # two kinds of device
    with pytest.raises(ValueError):
        stochastic_quantize_rows(rows, ids=torch.zeros((8, 2), dtype=torch.int32,
                                                       device="cuda")[:, 0], salt=1)


def _model(device, packed=False, bits=8, groups=1):
    return DCNv2(sparse_columns=[tfc.CategoricalColumnWithIdentity(f"c_{i}", VOCAB)
                                 for i in range(FIELDS)],
                 dense_columns=[tfc.NumericColumn(f"d_{i}") for i in range(3)],
                 label_column=tfc.CategoricalColumnWithIdentity("label", 2), emb_size=E,
                 num_cross_layers=2, layers=(32, 16), unified_embedding=True,
                 quantized_embedding=True, table_packed=packed, table_bits=bits,
                 scale_col_groups=groups, device=device,
                 generator=torch.Generator(device=device).manual_seed(0))


def _batches(n, rows, rng, unique=False):
    out = []
    for _ in range(n):
        if unique:
            batch = {f"c_{i}": rng.permutation(VOCAB)[:rows].astype(np.int32)
                     for i in range(FIELDS)}
        else:
            batch = {f"c_{i}": rng.integers(0, VOCAB, rows).astype(np.int32)
                     for i in range(FIELDS)}
        batch.update({f"d_{i}": rng.normal(size=rows).astype(np.float32) for i in range(3)})
        batch["label"] = rng.integers(0, 2, rows).astype(np.int32)
        out.append(batch)
    return out


def _trainer(device, batch, packed=False, bits=8, groups=1):
    trainer = QuantizedEmbeddingTrainer(_model(device, packed, bits, groups), device=device,
                                        packed_tables=packed)
    trainer.compile(optimizer="adam", lr=1e-2, loss="bce")
    trainer.init_state(batch, seed=0)
    return trainer


@pytest.mark.gpu
def test_two_classic_steps_on_the_card_match_the_cpu():
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = _batches(2, 512, np.random.default_rng(0))
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = _trainer(device, batches[0])
        if device == "cpu":  # the card's initial state, so only the steps differ
            trainer.model.load_state_dict(start)
        else:
            start = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        before = _counts()
        losses = torch.stack([trainer.train_step(b) for b in batches]).cpu()
        launched = [a - b for a, b in zip(_counts(), before)]
        want = [2, 2, 2, 0, 4] if device == "cuda" else [0] * len(KERNELS)
        assert launched == want  # a step: B1, B2, B8 once each, B4 for q and for scale
        state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
        runs[device] = losses, state, trainer.state.table_acc["unified"].cpu()
    (card_loss, card, card_acc), (cpu_loss, cpu, cpu_acc) = runs["cuda"], runs["cpu"]
    torch.testing.assert_close(card_loss, cpu_loss, rtol=1e-5, atol=0.0)
    for key in cpu:
        if key not in ("unified_q", "unified_scale"):
            torch.testing.assert_close(card[key], cpu[key], rtol=1e-4, atol=1e-6)
    touched = torch.from_numpy(np.unique(np.concatenate(
        [b[f"c_{i}"] + VOCAB * i for b in batches for i in range(FIELDS)])))
    torch.testing.assert_close(card["unified_scale"][touched], cpu["unified_scale"][touched],
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(card_acc, cpu_acc, rtol=1e-4, atol=1e-6)
    assert bool((card_acc[touched] > 0).all())
    diff = (card["unified_q"][touched].int() - cpu["unified_q"][touched].int()).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= max(1, diff.numel() // 1000)


@pytest.mark.gpu
def test_classic_and_packed_steps_agree_on_the_card():
    """On unique ids B8 (classic) and B3 (packed) requantize the same rows
    with the same bits: equal q and scale."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = _batches(1, 256, np.random.default_rng(1), unique=True)[0]
    classic = _trainer("cuda", batch)
    packed = _trainer("cuda", batch, packed=True)
    packed.model.load_state_dict({k: v for k, v in classic.model.state_dict().items()
                                  if k not in ("unified_q", "unified_scale")}, strict=False)
    q0, s0 = classic.model.unified_q, classic.model.unified_scale
    packed.state.packed["unified_q"].copy_(pack_quantized_table(
        q0, s0, torch.zeros(q0.shape[0], device="cuda"), E))
    before = _counts()
    classic.train_step(batch)
    packed.train_step(batch)
    assert [a - b for a, b in zip(_counts(), before)] == [2, 2, 1, 1, 3]
    want_q, want_s, want_acc = packed.unpacked_quantized()["unified"]
    assert torch.equal(classic.model.unified_q.cpu(), want_q)
    assert torch.equal(classic.model.unified_scale.cpu(), want_s)
    torch.testing.assert_close(classic.state.table_acc["unified"].cpu(), want_acc, rtol=1e-6,
                               atol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,groups", [(4, 1), (8, 2)])
def test_classic_int4_and_scale_groups_launch_no_b8(bits, groups):
    _need_card()
    batches = _batches(3, 512, np.random.default_rng(2))
    trainer = _trainer("cuda", batches[0], bits=bits, groups=groups)
    before = _counts()
    losses = torch.stack([trainer.train_step(b) for b in batches]).cpu()
    assert [a - b for a, b in zip(_counts(), before)] == [3, 3, 0, 0, 6]
    assert bool(torch.isfinite(losses).all())
    assert bool((trainer.state.table_acc["unified"] > 0).any())
