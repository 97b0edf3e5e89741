"""B8's keyed form on the CPU: ``stochastic_quantize_rows(rows, ids=, salt=)``
against the JAX package, on the same numpy rows, ids and salt.

On a CPU tensor the keyed form runs its plain version (the int64 hash of
``id_keyed_rounding_bits``, then the given-bits quantization). Against
``quantize_rows_xla(rows, rng_bits=id_keyed_rounding_bits(ids, e, salt))``,
the function the JAX package's classic trainer runs, it agrees bit for bit
(q and scale equal). Against ``quantize_rows_pallas`` in interpret mode,
which scales by ``absmax * (1 / 127)``, the scale is within rtol 1e-6 and q
equal wherever the two scales are (the rule of
``tests/test_torch_quantize_rows.py``). Ids reach 2**31 - 1 and the salt is
at 2**31 or above, so the hash's products wrap and its bits cross 2**31.
Also: the wrapper refuses two forms, none, and ids or a salt the kernel
cannot take; ``quantize_geometry`` lays out the card's rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.kernels import quantize as jq
from pytorchrec_tpu_torch.ops.kernels.quantize import (
    QuantizeGeometry,
    id_keyed_rounding_bits,
    quantize_geometry,
    rounding_bits_i32,
    stochastic_quantize_rows,
    stochastic_quantize_rows_keyed_plain,
    stochastic_quantize_rows_plain,
)

SHAPES = [(1, 1), (7, 1), (300, 16), (1000, 64)]
SALTS = [2**31, 0xDEADBEEF, 2**32 - 1]


def _inputs(n, e, seed):
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((n, e)) * 0.01).astype(np.float32)
    rows[n // 2] = 0.0  # all zero: scale 1
    ids = rng.integers(0, 2**31, size=n, dtype=np.int64).astype(np.int32)
    ids[0] = 2**31 - 1
    if n > 1:
        ids[1] = 0
    return rows, ids


def _keyed(rows, ids, salt):
    q, scale = stochastic_quantize_rows(torch.from_numpy(rows), ids=torch.from_numpy(ids),
                                        salt=salt)
    return q.numpy(), scale.numpy()


def _jax_bits(ids, e, salt):
    return jq.id_keyed_rounding_bits(jnp.asarray(ids), e, jnp.uint32(salt))


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("n,e", SHAPES)
def test_keyed_form_matches_jax_bit_for_bit(n, e, salt):
    rows, ids = _inputs(n, e, n * 7 + e)
    before = stochastic_quantize_rows.launches
    q, scale = _keyed(rows, ids, salt)
    assert stochastic_quantize_rows.launches == before  # the CPU runs the plain version
    assert q.dtype == np.int8 and q.shape == (n, e)
    assert scale.dtype == np.float32 and scale.shape == (n,)
    bits = _jax_bits(ids, e, salt)
    want_q, want_scale = jq.quantize_rows_xla(jnp.asarray(rows), rng_bits=bits)
    np.testing.assert_array_equal(q, np.asarray(want_q))
    np.testing.assert_array_equal(scale.view(np.uint32), np.asarray(want_scale).view(np.uint32))
    assert scale[n // 2] == 1.0 and not q[n // 2].any()
    if n * e >= 64:
        assert int((np.asarray(bits) >= 2**31).sum()) > 0  # bit patterns past int32


@pytest.mark.parametrize("n,e", SHAPES)
def test_keyed_form_matches_the_pallas_kernel_in_interpret_mode(n, e):
    rows, ids = _inputs(n, e, n * 11 + e)
    salt = 0x80000001
    got_q, got_scale = _keyed(rows, ids, salt)
    q, scale = (np.asarray(a) for a in jq.quantize_rows_pallas(
        jnp.asarray(rows), _jax_bits(ids, e, salt), block_rows=256, interpret=True))
    np.testing.assert_allclose(got_scale, scale, rtol=1e-6, atol=0)
    same = got_scale == scale
    assert same.any()
    np.testing.assert_array_equal(got_q[same], q[same])


def test_keyed_form_is_the_given_form_with_the_hashed_bits():
    """The keyed plain version, the wrapper's two forms and the hash's bits
    as int32 patterns agree."""
    rows, ids = _inputs(500, 16, 3)
    salt = 0xFEEDF00D
    t_rows, t_ids = torch.from_numpy(rows), torch.from_numpy(ids)
    bits = rounding_bits_i32(id_keyed_rounding_bits(t_ids, 16, salt))
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  np.asarray(_jax_bits(ids, 16, salt)))
    keyed = stochastic_quantize_rows(t_rows, ids=t_ids, salt=salt)
    for other in (stochastic_quantize_rows(t_rows, bits),
                  stochastic_quantize_rows_plain(t_rows, bits),
                  stochastic_quantize_rows_keyed_plain(t_rows, t_ids, salt)):
        assert torch.equal(keyed[0], other[0]) and torch.equal(keyed[1], other[1])
    # a numpy integer salt is the same salt
    again = stochastic_quantize_rows(t_rows, ids=t_ids, salt=np.uint32(salt))
    assert torch.equal(keyed[0], again[0]) and torch.equal(keyed[1], again[1])


@pytest.mark.parametrize("change", ["both", "neither", "ids_only", "salt_only", "ids_shape",
                                    "ids_2d", "ids_int64", "ids_float", "salt_negative",
                                    "salt_2_32", "salt_float", "salt_bool"])
def test_the_wrapper_refuses_what_the_keyed_form_cannot_take(change):
    rows = torch.zeros((4, 8))
    kwargs = {"ids": torch.zeros((4,), dtype=torch.int32), "salt": 7}
    args = ()
    if change == "both":
        args = (torch.zeros((4, 8), dtype=torch.int32),)
    elif change == "neither":
        kwargs = {}
    elif change == "ids_only":
        del kwargs["salt"]
    elif change == "salt_only":
        del kwargs["ids"]
    elif change == "ids_shape":
        kwargs["ids"] = torch.zeros((5,), dtype=torch.int32)
    elif change == "ids_2d":
        kwargs["ids"] = torch.zeros((4, 1), dtype=torch.int32)
    elif change == "ids_int64":
        kwargs["ids"] = torch.zeros((4,), dtype=torch.int64)
    elif change == "ids_float":
        kwargs["ids"] = torch.zeros((4,))
    elif change == "salt_negative":
        kwargs["salt"] = -1
    elif change == "salt_2_32":
        kwargs["salt"] = 2**32
    elif change == "salt_float":
        kwargs["salt"] = 7.0
    else:
        kwargs["salt"] = True
    with pytest.raises((TypeError, ValueError)):
        stochastic_quantize_rows(rows, *args, **kwargs)


def test_geometry_at_the_main_path_shape_and_the_edges():
    assert quantize_geometry(16) == QuantizeGeometry(4, True)    # 4 lanes a row, 8 rows a warp
    assert quantize_geometry(64) == QuantizeGeometry(16, True)
    assert quantize_geometry(4) == QuantizeGeometry(1, True)
    assert quantize_geometry(100) == QuantizeGeometry(32, True)  # 25 words, 7 lanes idle
    assert quantize_geometry(128) == QuantizeGeometry(32, True)  # the widest words row
    assert quantize_geometry(1) == QuantizeGeometry(1, False)    # scalar: E not a multiple of 4
    assert quantize_geometry(7) == QuantizeGeometry(8, False)
    assert quantize_geometry(37) == QuantizeGeometry(32, False)
    assert quantize_geometry(16, aligned=False) == QuantizeGeometry(16, False)
    assert quantize_geometry(132) == QuantizeGeometry(32, False)  # past 32 lanes of one word
    with pytest.raises(ValueError):
        quantize_geometry(0)


@pytest.mark.parametrize("e", range(1, 600, 7))
def test_geometry_covers_every_column(e):
    """The words path's lanes hold every word of a row, one word a lane; the
    scalar path's group is a power of two of at most 32 lanes."""
    geo = quantize_geometry(e)
    assert geo.group in (1, 2, 4, 8, 16, 32)
    if geo.words:
        assert e % 4 == 0 and e // 4 <= geo.group < e // 2
    else:
        assert e % 4 or e > 128
        assert geo.group == min(32, 1 << (e - 1).bit_length())
