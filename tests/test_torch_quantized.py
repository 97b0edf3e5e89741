"""The port's quantized-row layout against the JAX package's, bit for bit.

The same numpy bytes go through ``pytorchrec_tpu`` (JAX, CPU) and
``pytorchrec_tpu_torch`` (torch, CPU) for int8 and int4 rows with one and two
column groups of scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu.ops.kernels import quantize as jq
from pytorchrec_tpu_torch.ops import quantized_packed as tqp
from pytorchrec_tpu_torch.ops import sparse_update as tsu
from pytorchrec_tpu_torch.ops.kernels import quantize as tq

E = 8
FORMATS = [(bits, groups) for bits in (8, 4) for groups in (1, 2)]


def _rows(n=23, seed=0):
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(n, E)) * 0.01).astype(np.float32)
    rows[3] = 0.0  # an all-zero row takes scale 1
    return rows


def _jax_table(bits, groups, seed=0):
    """Packed [V, W] u8 rows made by the JAX package."""
    q, scale = jq.quantize_rows_xla(jnp.asarray(_rows(seed=seed)), bits=bits, col_groups=groups)
    acc = jnp.asarray(np.random.default_rng(seed + 1).random(q.shape[0]).astype(np.float32))
    return np.array(jqp.pack_quantized_table(q, scale, acc, E, bits, groups))  # writable


def _exact(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,groups", FORMATS)
def test_quantize_rows_matches_jax(bits, groups):
    rows = _rows()
    jq_, js = jq.quantize_rows_xla(jnp.asarray(rows), bits=bits, col_groups=groups)
    tq_, ts = tq.quantize_rows(torch.from_numpy(rows), bits=bits, col_groups=groups)
    _exact(tq_, jq_)
    _exact(ts, js)


@pytest.mark.parametrize("bits,groups", FORMATS)
def test_dequantize_rows_matches_jax(bits, groups):
    q, scale = jq.quantize_rows_xla(jnp.asarray(_rows(seed=1)), bits=bits, col_groups=groups)
    want = jq.dequantize_rows(q, scale, bits=bits, col_groups=groups)
    got = tq.dequantize_rows(torch.tensor(np.asarray(q)), torch.tensor(np.asarray(scale)),
                             bits=bits, col_groups=groups)
    _exact(got, want)


def test_int4_pack_roundtrip_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.integers(-7, 8, size=(11, E)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(q))
    _exact(packed, jq.pack_int4(jnp.asarray(q)))
    # every byte value, including the -8 nibble the packer never writes
    all_bytes = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    _exact(tq.unpack_int4(torch.from_numpy(all_bytes)), jq.unpack_int4(jnp.asarray(all_bytes)))
    _exact(tq.unpack_int4(packed), q)


@pytest.mark.parametrize("bits,groups", FORMATS)
def test_pack_quantized_table_matches_jax(bits, groups):
    rows = _rows()
    q, scale = tq.quantize_rows(torch.from_numpy(rows), bits=bits, col_groups=groups)
    acc = torch.from_numpy(np.random.default_rng(1).random(q.shape[0]).astype(np.float32))
    got = tqp.pack_quantized_table(q, scale, acc, E, bits, groups)
    assert got.shape[1] == tqp.packed_q_width(E, bits, groups) == jqp.packed_q_width(E, bits, groups)
    assert tqp.packed_q_base(E, bits, groups) == jqp.packed_q_base(E, bits, groups)
    _exact(got, _jax_table(bits, groups))


@pytest.mark.parametrize("bits,groups", FORMATS)
def test_dequant_packed_rows_matches_jax(bits, groups):
    table = _jax_table(bits, groups, seed=3)
    want = jqp.dequant_packed_rows(jnp.asarray(table), E, bits, groups)
    _exact(tqp.dequant_packed_rows(torch.from_numpy(table), E, bits, groups), want)


@pytest.mark.parametrize("bits,groups", FORMATS)
def test_packed_gather_dequant_matches_jax(bits, groups):
    table = _jax_table(bits, groups, seed=4)
    ids = np.random.default_rng(5).integers(0, table.shape[0], size=(6, 3)).astype(np.int32)
    want = jqp.packed_gather_dequant(jnp.asarray(table), jnp.asarray(ids), E, bits, groups)
    got = tqp.packed_gather_dequant(torch.from_numpy(table), torch.from_numpy(ids).long(),
                                    E, bits, groups)
    assert got.shape == (6, 3, E)
    _exact(got, want)


def test_f32_byte_views_match_jax():
    from pytorchrec_tpu.ops import sparse_update as jsu

    x = np.random.default_rng(6).normal(size=(5, 3)).astype(np.float32)
    as_bytes = tsu.f32_to_bytes(torch.from_numpy(x))
    _exact(as_bytes, jsu.f32_to_bytes(jnp.asarray(x)))
    _exact(tsu.bytes_to_f32(as_bytes), x)
    # a column slice of a wider byte row (not contiguous) reads back too
    wide = torch.cat([torch.zeros(5, 4, dtype=torch.uint8), as_bytes], dim=1)
    _exact(tsu.bytes_to_f32(wide[:, 4:]), x)
    packed = np.random.default_rng(7).normal(size=(4, 64)).astype(np.float32)
    _exact(tsu.unpack_table(torch.from_numpy(packed), E),
           jsu.unpack_table(jnp.asarray(packed), E))
    assert tsu._FAST_WIDTH == jsu._FAST_WIDTH


@pytest.mark.parametrize("bits,groups,e", [(4, 1, 4), (8, 1, 5), (8, 2, 6)])
def test_one_row_at_an_unaligned_scale_offset_matches_jax(bits, groups, e):
    """A single gathered row whose scale starts at a byte offset that is not
    a multiple of 4 (int4 at E=4: byte 2) still reads back: its one-row
    column slice is contiguous, so it is copied to an aligned start before
    the f32 view."""
    rows = (np.random.default_rng(e).normal(size=(5, e)) * 0.01).astype(np.float32)
    q, scale = jq.quantize_rows_xla(jnp.asarray(rows), bits=bits, col_groups=groups)
    table = np.array(jqp.pack_quantized_table(q, scale, jnp.ones((5,), jnp.float32), e, bits,
                                              groups))
    ids = np.array([[3]], np.int32)
    want = jqp.packed_gather_dequant(jnp.asarray(table), jnp.asarray(ids), e, bits, groups)
    got = tqp.packed_gather_dequant(torch.from_numpy(table), torch.from_numpy(ids).long(),
                                    e, bits, groups)
    _exact(got, want)
    one, qb = torch.from_numpy(table)[3:4], tqp.q_row_bytes(e, bits)
    _exact(tsu.bytes_to_f32(one[:, qb:qb + 4 * groups]),
           np.asarray(jqp.unpack_quantized_table(jnp.asarray(table[3:4]), e, bits, groups)[1]
                      ).reshape(1, -1))
