"""The int8 table update's pieces, the port against the JAX package, on the
CPU: the id-keyed rounding bits, stochastic quantization, the requantize
kernel's plain version (against the Pallas kernel in interpret mode and
against the XLA chain) and the whole packed quantized update.

Tolerances: bits and q bytes exact; scale and accumulator rtol 3e-7, the
JAX package's own kernel-against-chain tolerance for a sum of g^2 taken in
another order (the port sums in column order, as XLA's CPU reduction does,
and agrees bit for bit here); after a whole update the q values may differ
by one where the summed duplicate grads (another order) put
``row / scale + u`` on an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops import quantized_packed as jqp
from pytorchrec_tpu.ops.kernels import quantize as jq
from pytorchrec_tpu_torch.ops import quantized_packed as tqp
from pytorchrec_tpu_torch.ops.kernels import quantize as tq

E = 16
W = 128
SALT = 0x9E3779B9 ^ 12345


def _ids(n, seed, near_top=False):
    rng = np.random.default_rng(seed)
    if near_top:
        return (2**31 - 1 - rng.integers(0, 1000, n)).astype(np.int32)
    return rng.integers(0, 5000, n).astype(np.int32)


def test_id_keyed_rounding_bits_match_jax():
    for ids, offset in ((_ids(50, 0), 0), (_ids(50, 1), 11), (_ids(50, 2, near_top=True), 0),
                        (_ids(50, 3, near_top=True), 7)):
        want = jq.id_keyed_rounding_bits(jnp.asarray(ids) + offset, E, jnp.uint32(SALT))
        got = tq.id_keyed_rounding_bits(torch.from_numpy(ids).to(torch.int64) + offset, E, SALT)
        assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < 2**32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("bits,groups", [(8, 1), (8, 2), (4, 1), (4, 2)])
def test_stochastic_quantize_rows_matches_jax(bits, groups):
    rng = np.random.default_rng(bits + groups)
    rows = (rng.normal(size=(40, E)) * 0.01).astype(np.float32)
    rows[5] = 0.0
    rbits = rng.integers(0, 2**32, size=(40, E), dtype=np.uint64).astype(np.uint32)
    jq_, js = jq.quantize_rows_xla(jnp.asarray(rows), rng_bits=jnp.asarray(rbits), bits=bits,
                                   col_groups=groups)
    tq_, ts = tq.quantize_rows(torch.from_numpy(rows), torch.from_numpy(rbits.astype(np.int64)),
                               bits=bits, col_groups=groups)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _moved(n, seed):
    """Permuted int8 packed rows (q || scale || acc || staging || pad), the
    summed grads and the global ids, as the update hands them to B3: one
    all-zero row with zero grads (scale 1 afterwards) and negative q bytes."""
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(n, E)) * 0.01).astype(np.float32)
    q, scale = jq.quantize_rows_xla(jnp.asarray(rows))
    acc = jnp.asarray(rng.random(n).astype(np.float32) * 1e-3)
    moved = np.array(jqp.pack_quantized_table(q, scale, acc, E))
    moved[:, 24:24 + 4 * E] = rng.integers(0, 256, (n, 4 * E))  # staged grads ride along
    g = rng.normal(size=(n, E)).astype(np.float32)
    if n > 1:
        moved[n // 2, :E] = 0
        g[n // 2] = 0.0
    return moved, g, _ids(n, seed, near_top=seed % 2 == 1)


def _jax_chain(moved, g, ids, salt, lr, eps=1e-6):
    """The JAX package's XLA chain (``quantized_packed.py:270-317``) at
    bits=8 and one scale a row."""
    moved = jnp.asarray(moved)
    q_old, scale_old, acc_old = jqp.unpack_quantized_table(moved, E)
    current = jq.dequantize_rows(q_old, scale_old)
    acc_new = acc_old + jnp.mean(jnp.square(g), axis=-1)
    new_rows = current - lr * g / (jnp.sqrt(acc_new)[:, None] + eps)
    bits = jq.id_keyed_rounding_bits(jnp.asarray(ids), E, jnp.uint32(salt))
    q_new, s_new = jq.quantize_rows_xla(new_rows, rng_bits=bits)
    return np.asarray(jqp.pack_quantized_table(q_new, s_new, acc_new, E))


def _assert_rows_match(got, want, q_flips=0):
    """q bytes equal (up to ``q_flips`` values off by one), scale and acc
    rtol 3e-7, everything after them zero."""
    got = np.asarray(got)
    gq, gs, ga = (np.asarray(a) for a in jqp.unpack_quantized_table(jnp.asarray(got), E))
    wq, ws, wa = (np.asarray(a) for a in jqp.unpack_quantized_table(jnp.asarray(want), E))
    diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
    assert diff.max(initial=0) <= 1 and int((diff > 0).sum()) <= q_flips
    np.testing.assert_allclose(gs, ws, rtol=3e-7)
    np.testing.assert_allclose(ga, wa, rtol=3e-7)
    assert not got[:, E + 8:].any()


@pytest.mark.parametrize("n", [1, 37, 300])
@pytest.mark.parametrize("lr", [0.01, 10.0])
def test_requantize_plain_matches_pallas_kernel_and_chain(n, lr):
    moved, g, ids = _moved(n, seed=n + int(lr))
    got = tq.requantize_rows_plain(torch.from_numpy(moved), torch.from_numpy(g),
                                   torch.from_numpy(ids), SALT, lr, E)
    assert got.shape == (n, W) and got.dtype == torch.uint8
    pallas = jq.requantize_rows_pallas(jnp.asarray(moved), jnp.asarray(g), jnp.asarray(ids),
                                       jnp.uint32(SALT), lr, E, block_rows=8, interpret=True)
    _assert_rows_match(got.numpy(), pallas)
    _assert_rows_match(got.numpy(), _jax_chain(moved, g, ids, SALT, lr))
    if n > 1:  # the all-zero row keeps scale 1 and q 0
        q, scale, _ = tqp.unpack_quantized_table(got, E)
        assert float(scale[n // 2]) == 1.0 and not q[n // 2].any()
    if lr == 10.0:  # the grads dominate: some q reach the clip
        assert int(tqp.unpack_quantized_table(got, E)[0].abs().max()) == 127


def test_requantize_wrapper_takes_the_plain_version_on_the_cpu():
    moved, g, ids = _moved(37, seed=5)
    before = tq.requantize_rows.launches
    got = tq.requantize_rows(torch.from_numpy(moved), torch.from_numpy(g),
                             torch.from_numpy(ids), SALT, 0.01, E)
    assert tq.requantize_rows.launches == before
    want = tq.requantize_rows_plain(torch.from_numpy(moved), torch.from_numpy(g),
                                    torch.from_numpy(ids), SALT, 0.01, E)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):  # no room for scale and acc
        tq.requantize_rows(torch.from_numpy(moved[:, :E + 4]), torch.from_numpy(g),
                           torch.from_numpy(ids), SALT, 0.01, E)
    with pytest.raises(TypeError):
        tq.requantize_rows(torch.from_numpy(moved), torch.from_numpy(g),
                           torch.from_numpy(ids).long(), SALT, 0.01, E)


@pytest.mark.parametrize("w,e", [(128, 16), (384, 64), (64, 4), (256, 37), (132, 16), (16, 8),
                                 (20, 7), (12, 1), (1024, 128), (600, 129), (1024, 512),
                                 (4096, 512)])
def test_requantize_geometry_covers_every_row(w, e):
    """B3's layout: a power-of-two group of 4 to 32 lanes a row whose q words
    (4 columns a lane and word) hold all e columns, in a built instance;
    16-byte stores where W is a multiple of 16, else 4-byte ones."""
    geo = tq.requantize_geometry(w, e)
    assert (geo.group, geo.words) in tq.REQUANTIZE_INSTANCES
    assert geo.group in (4, 8, 16, 32) and geo.rows_per_warp * geo.group == 32
    assert 4 * geo.group * geo.words >= e
    assert geo.unit == (16 if w % 16 == 0 else 4)
    q_words = -(-e // 4)
    if q_words <= 32:  # one word a lane, no lane without one past the first four
        assert geo.words == 1 and (geo.group == 4 or geo.group // 2 < q_words)


def test_requantize_geometry_at_the_main_path_shapes():
    # int8 DCN-v2, DeepFM and two-tower rows (E=16, 128 bytes): 8 rows a warp;
    # DIN's (E=64, 384 bytes): 2 rows a warp, 16 lanes of 4 columns each
    assert tq.requantize_geometry(128, 16) == tq.RequantizeGeometry(4, 1, 16)
    assert tq.requantize_geometry(384, 64) == tq.RequantizeGeometry(16, 1, 16)
    assert tq.requantize_geometry(128, 16).rows_per_warp == 8


@pytest.mark.parametrize("w,e", [(128, 0), (20, 13), (130, 16), (4100, 16), (1024, 513),
                                 (4096, 4088)])
def test_requantize_geometry_rejects_rows_the_kernel_cannot_take(w, e):
    with pytest.raises(ValueError):
        tq.requantize_geometry(w, e)


def _table(v, e, bits, groups, seed):
    rng = np.random.default_rng(seed)
    q, s = jq.quantize_rows_xla(jnp.asarray((rng.normal(size=(v, e)) * 0.01).astype(np.float32)),
                                bits=bits, col_groups=groups)
    acc = jnp.asarray(rng.random(v).astype(np.float32) * 1e-3)
    return np.array(jqp.pack_quantized_table(q, s, acc, e, bits, groups))


@pytest.mark.parametrize("keyed", ["salt", "bits"])
@pytest.mark.parametrize("bits,groups,e", [(8, 1, 16), (8, 2, 16), (4, 1, 16), (4, 2, 8),
                                           (4, 1, 4)])
def test_packed_quantized_update_matches_jax(bits, groups, e, keyed):
    """Modelled on the JAX package's kernel-against-chain test: 200 draws
    of 300 ids (duplicates), ``ids_offset=11``. int4 at E=4 stages its grads
    at byte 10, where no f32 view of the rows exists."""
    rng = np.random.default_rng(bits * 10 + groups + e)
    v, n = 300, 200
    table = _table(v, e, bits, groups, seed=e)
    ids = rng.integers(0, v, size=n).astype(np.int32)
    dvec = rng.normal(size=(n, e)).astype(np.float32)
    rbits = rng.integers(0, 2**32, size=(n, e), dtype=np.uint64).astype(np.uint32)
    salted = keyed == "salt"
    port_salt = {"rng_salt": SALT, "ids_offset": 11} if salted else {}
    want = jqp.packed_quantized_update(
        jnp.asarray(table), jnp.asarray(table)[ids], jnp.asarray(ids), jnp.asarray(dvec),
        None if salted else jnp.asarray(rbits), 0.01, bits=bits, col_groups=groups,
        **({"rng_salt": jnp.uint32(SALT), "ids_offset": 11} if salted else {}))
    packed = torch.from_numpy(table.copy())
    address = packed.data_ptr()
    got = tqp.packed_quantized_update(
        packed, packed[torch.from_numpy(ids).long()], torch.from_numpy(ids),
        torch.from_numpy(dvec), None if salted else torch.from_numpy(rbits.astype(np.int64)),
        0.01, bits=bits, col_groups=groups, **port_salt)
    assert got is packed and packed.data_ptr() == address  # in place
    want = np.asarray(want)
    untouched = np.setdiff1d(np.arange(v), ids)
    np.testing.assert_array_equal(got.numpy()[untouched], want[untouched])
    gq, gs, ga = (a.numpy() for a in tqp.unpack_quantized_table(got, e, bits, groups))
    wq, ws, wa = (np.asarray(a) for a in jqp.unpack_quantized_table(jnp.asarray(want), e,
                                                                      bits, groups))
    if bits == 4:
        gq, wq = (np.asarray(jq.unpack_int4(jnp.asarray(a))) for a in (gq, wq))
    diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, diff.size // 1000)
    np.testing.assert_allclose(gs, ws, rtol=1e-6)
    np.testing.assert_allclose(ga, wa, rtol=1e-6)
    assert not got.numpy()[:, tqp.packed_q_base(e, bits, groups):].any()
