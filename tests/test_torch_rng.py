"""The port's host key arithmetic (``utils/rng.py``) and rounding salt
against ``jax.random`` and the JAX package's ``table_rounding_salt``, bit for
bit."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorchrec_tpu.ops.kernels import quantize as jq
from pytorchrec_tpu_torch.ops.kernels import quantize as tq
from pytorchrec_tpu_torch.utils import rng

SEEDS = (0, 1, 7, 2020, 2**31 - 1)
PATHS = ("unified_q", "item_q")


def _crc(path):
    return zlib.crc32(path.encode()) & 0x7FFFFFFF


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(rng.prng_key(seed), np.asarray(key))
    for num in (2, 3):
        got = rng.split(rng.prng_key(seed), num)
        assert got.dtype == np.uint32 and got.shape == (num, 2)
        np.testing.assert_array_equal(got, np.asarray(jax.random.split(key, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_bits_match_jax(seed):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    mine = rng.split(rng.prng_key(seed))[1]
    for data in (0, 1, 12345, 2**31 - 1, _crc("unified_q")):
        np.testing.assert_array_equal(rng.fold_in(mine, data),
                                      np.asarray(jax.random.fold_in(key, data)))
    assert rng.random_bits_u32(mine) == int(jax.random.bits(key, (), jnp.uint32))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("seed", (0, 2020))
def test_table_rounding_salt_matches_jax(seed, path):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    mine = rng.split(rng.prng_key(seed))[1]
    for step in (1, 2, 1000, 2**31 - 1):  # the last wraps the multiply
        want = int(jq.table_rounding_salt(key, jnp.asarray(step, jnp.int32), path))
        assert tq.table_rounding_salt(mine, step, path) == want


def test_seed_outside_32_bits_raises():
    with pytest.raises(ValueError):
        rng.prng_key(2**31)
