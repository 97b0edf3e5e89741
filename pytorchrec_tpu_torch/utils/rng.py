"""The JAX package's PRNG key arithmetic, on the host, in plain integers.

The int8 table update salts its rounding bits from the train state's key
(``ops/kernels/quantize.py::table_rounding_salt``), and the JAX package
derives that key with ``jax.random``. The port keeps the same key so that
both draw the same rounding bits from the same seed: threefry-2x32 (20
rounds) and the four operations the salt needs, in the form ``jax.random``
takes with ``jax_threefry_partitionable`` on (its default):

* ``prng_key(seed)`` is ``(0, seed)``;
* ``split(key, num)[i]`` is ``threefry(key, (0, i))``;
* ``fold_in(key, data)`` is ``threefry(key, (0, data))``;
* ``random_bits_u32(key)`` (``jax.random.bits(key, (), uint32)``) is
  ``x0 ^ x1`` of ``threefry(key, (0, 0))``.

A key is a numpy ``uint32[2]``, as ``jax.random.key_data`` gives it. All of
this runs on the host: a step's salt costs the device nothing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, count: Tuple[int, int]) -> Tuple[int, int]:
    """Threefry-2x32 with 20 rounds: ``key`` (two uint32 words) hashes the
    counter ``count`` (two uint32 words) into two uint32 words."""
    k0, k1 = (int(k) & _MASK for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (count[0] + ks[0]) & _MASK, (count[1] + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def _key(words: Tuple[int, int]) -> np.ndarray:
    return np.array(words, dtype=np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return _key((0, seed & _MASK))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` uint32 keys."""
    return np.stack([_key(threefry2x32(key, (0, i))) for i in range(num)])


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for 32-bit ``data``."""
    return _key(threefry2x32(key, (0, data & _MASK)))


def random_bits_u32(key) -> int:
    """``jax.random.bits(key, (), jnp.uint32)`` as a Python int."""
    x0, x1 = threefry2x32(key, (0, 0))
    return x0 ^ x1
