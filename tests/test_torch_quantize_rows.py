"""B8, the stochastic row quantization, on the CPU: the port's plain version
against the JAX package's Pallas kernel in interpret mode and its XLA twin,
on the same numpy rows and bits; and the int32 bit patterns the kernel
takes.

``quantize_rows_xla(rows, rng_bits=bits)``, the function the JAX package's
classic trainer runs, and ``stochastic_quantize_rows_plain`` agree bit for
bit (q and scale equal, no tolerance): an absmax, one correctly rounded
division for the scale and one for each value, an f32 add and a floor.
``quantize_rows_pallas(rows, bits, interpret=True)`` computes the scale as
``absmax * (1 / 127)``, one rounding more, so a few scales sit one ulp from
the twin's (the JAX package's own test allows rtol 1e-6 there): against it
the port's scale is within rtol 1e-6 and its q bytes are equal wherever the
scales are. The rows cover the kernel's edges:
all-zero rows (scale 1), values whose ``row / scale + u`` lands exactly on
an integer, bits of ``2**31`` and above (a logical shift: uint32, never
sign-extended), and values that clip at +-127.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.kernels import quantize as jq
from pytorchrec_tpu_torch.ops.kernels.quantize import (
    id_keyed_rounding_bits,
    quantize_rows,
    rounding_bits_i32,
    stochastic_quantize_rows,
    stochastic_quantize_rows_plain,
)

SHAPES = [(1, 1), (7, 1), (32, 8), (300, 16), (1000, 64)]


def _rows_and_bits(n, e, seed):
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((n, e)) * 0.01).astype(np.float32)
    bits = rng.integers(0, 2**32, size=(n, e), dtype=np.uint64).astype(np.uint32)
    return rows, bits


def _edge_rows(e=16):
    """Rows that reach every edge of the function, with their bits."""
    rows, bits = _rows_and_bits(8, e, 99)
    rows[0] = 0.0                                           # all zero: scale 1, q 0
    rows[1] = np.arange(-63, -63 + e, dtype=np.float32) * np.float32(2.0**-7)
    rows[1, 0] = np.float32(-127 * 2.0**-7)                 # scale 2**-7: row / scale exact
    bits[1] = 0x80                                          # u = 0: the quotient is an integer
    rows[2] = (np.arange(e, dtype=np.float32) + np.float32(0.5)) * np.float32(2.0**-7)
    rows[2, -1] = np.float32(127 * 2.0**-7)
    bits[2] = 0x80000000                                    # u = 1/2: k + 1/2 + 1/2 lands on k + 1
    rows[3, 0] = np.float32(127 * 2.0**-7)                 # absmax / scale is exactly 127 ...
    bits[3] = 0xFFFFFFFF                                    # ... and u just under 1: 128 clips
    rows[4] = -np.abs(rows[4])
    rows[4, 0] = -_over_127()                               # absmax / scale just over 127 ...
    bits[4] = 0                                             # ... and u = 0: -128 clips
    bits[5] = 0xF0000000                                    # every bit pattern >= 2**31
    rows[6, 3] = np.float32(1e-3)                           # one large value and many small ones
    rows[7] = np.float32(-0.0)
    return rows, bits


def _over_127():
    """An f32 x with x / (x / 127) above 127 in f32 arithmetic."""
    for x in np.linspace(0.5, 1.0, 4001, dtype=np.float32):
        if x / (x / np.float32(127)) > np.float32(127):
            return x
    raise AssertionError("no such x")


def _port(rows, bits):
    q, scale = stochastic_quantize_rows(torch.from_numpy(rows),
                                        torch.from_numpy(bits.view(np.int32)))
    return q.numpy(), scale.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].view(np.uint32), np.asarray(want[1]).view(np.uint32))


def _assert_as_interpreted(got, rows, bits, block_rows=256):
    """Against the Pallas kernel in interpret mode: its scale is
    ``absmax * f32(1 / 127)``; the port's within rtol 1e-6 of it, and every
    q byte equal where the two scales are."""
    q, scale = (np.asarray(a) for a in jq.quantize_rows_pallas(
        jnp.asarray(rows), jnp.asarray(bits), block_rows=block_rows, interpret=True))
    absmax = np.abs(rows).max(axis=1)
    np.testing.assert_array_equal(
        scale, np.where(absmax > 0, absmax * np.float32(1 / 127), np.float32(1)))
    np.testing.assert_allclose(got[1], scale, rtol=1e-6, atol=0)
    same = got[1] == scale
    np.testing.assert_array_equal(got[0][same], q[same])


@pytest.mark.parametrize("n,e", SHAPES)
def test_plain_matches_the_pallas_kernel_and_its_twin(n, e):
    rows, bits = _rows_and_bits(n, e, n * 131 + e)
    got = _port(rows, bits)
    assert got[0].dtype == np.int8 and got[0].shape == (n, e)
    assert got[1].dtype == np.float32 and got[1].shape == (n,)
    _assert_same(got, jq.quantize_rows_xla(jnp.asarray(rows), rng_bits=jnp.asarray(bits)))
    _assert_as_interpreted(got, rows, bits)


def test_edge_rows_match_jax_bit_for_bit():
    rows, bits = _edge_rows()
    got = _port(rows, bits)
    _assert_same(got, jq.quantize_rows_xla(jnp.asarray(rows), rng_bits=jnp.asarray(bits)))
    _assert_as_interpreted(got, rows, bits, block_rows=8)
    q, scale = got
    assert scale[0] == 1.0 and not q[0].any() and scale[7] == 1.0 and not q[7].any()
    assert scale[1] == scale[2] == np.float32(2.0**-7)
    np.testing.assert_array_equal(q[1], np.round(rows[1] / np.float32(2.0**-7)))
    np.testing.assert_array_equal(q[2][:-1], np.arange(1, rows.shape[1]))  # k + 1/2 + 1/2
    assert q[2][-1] == 127  # floor(127 + 1/2)
    # the absmax values reach 128 and -128 before the clip
    assert rows[3, 0] / scale[3] + np.float32(0xFFFFFF / 2**24) == np.float32(128)
    assert np.floor(rows[4, 0] / scale[4]) == -128.0
    assert q[3, 0] == 127 and q[4, 0] == -127
    assert q.min() >= -127 and q.max() <= 127


def test_id_keyed_bits_take_the_kernel_path_as_the_trainer_gives_them():
    """The classic step's bits: ``id_keyed_rounding_bits`` (int64) as int32
    patterns, against JAX's uint32 bits for the same ids and salt."""
    ids = np.arange(0, 300 * 37, 37, dtype=np.int32)
    salt = 0xDEADBEEF
    rows = _rows_and_bits(ids.shape[0], 16, 5)[0]
    bits64 = id_keyed_rounding_bits(torch.from_numpy(ids), 16, salt)
    want_bits = np.asarray(jq.id_keyed_rounding_bits(jnp.asarray(ids), 16, jnp.uint32(salt)))
    np.testing.assert_array_equal(bits64.numpy(), want_bits.astype(np.int64))
    assert int((bits64 >= 2**31).sum()) > 0
    bits32 = rounding_bits_i32(bits64)
    np.testing.assert_array_equal(bits32.numpy().view(np.uint32), want_bits)
    got = stochastic_quantize_rows(torch.from_numpy(rows), bits32)
    _assert_same((got[0].numpy(), got[1].numpy()),
                 jq.quantize_rows_xla(jnp.asarray(rows), rng_bits=jnp.asarray(want_bits)))
    # the same as quantize_rows with the int64 bits
    q, scale = quantize_rows(torch.from_numpy(rows), rng_bits=bits64)
    assert torch.equal(q, got[0]) and torch.equal(scale, got[1])


def test_bit_patterns_wrap_and_never_saturate():
    values = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1], dtype=torch.int64)
    got = rounding_bits_i32(values)
    assert got.dtype == torch.int32
    assert got.tolist() == [0, 1, 2**31 - 1, -2**31, -2**31 + 5, -1]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), values.numpy().astype(np.uint32))


def test_a_cpu_tensor_takes_the_plain_version():
    rows, bits = _rows_and_bits(50, 16, 3)
    before = stochastic_quantize_rows.launches
    got = stochastic_quantize_rows(torch.from_numpy(rows), torch.from_numpy(bits.view(np.int32)))
    want = stochastic_quantize_rows_plain(torch.from_numpy(rows),
                                          torch.from_numpy(bits.view(np.int32)))
    assert stochastic_quantize_rows.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("change", ["int64_bits", "f64_rows", "shape", "one_dim", "no_columns"])
def test_the_wrapper_raises_on_inputs_the_kernel_cannot_take(change):
    rows = torch.zeros((4, 8))
    bits = torch.zeros((4, 8), dtype=torch.int32)
    if change == "int64_bits":
        bits = bits.to(torch.int64)
    elif change == "f64_rows":
        rows = rows.double()
    elif change == "shape":
        bits = bits[:, :4]
    elif change == "one_dim":
        rows, bits = rows[0], bits[0]
    else:
        rows, bits = rows[:, :0], bits[:, :0]
    with pytest.raises((TypeError, ValueError)):
        stochastic_quantize_rows(rows, bits)
