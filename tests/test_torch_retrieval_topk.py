"""Kernel B7's contract on the CPU: the port's ``bin_max_scores`` (on CPU
tensors, its plain version) and ``bin_max_scores_plain`` against the JAX
package's XLA twin ``bin_max_scores_xla``, its Pallas kernel in interpret
mode (run as ``tests/test_pallas_kernels.py`` runs it) and the numpy
re-derivation of the contract.

Inputs are N(0, 1) from numpy seeds, queries f32, items f32 or bf16 (the
queries are cast to the items' dtype first, in both frameworks).
Tolerance: vals rtol 1e-5 / atol 1e-6 (f32 sums of D products in another
order; a value near 0 is a difference of terms of order 1, so its error is
absolute), ids equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.kernels import retrieval_topk as jrt
from pytorchrec_tpu_torch.ops.kernels import retrieval_topk as rt

RTOL, ATOL = 1e-5, 1e-6
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}

# (B, V, D, tc, group): tests/test_pallas_kernels.py's three, B=1, V=1 (one
# valid id, every other bin pad-only), a single partial super-chunk, and
# several super-chunks with a ragged tail
CASES = [
    (37, 1024, 16, 256, 2),
    (37, 1000, 16, 256, 2),
    (37, 700, 16, 256, 4),
    (1, 3000, 16, 256, 2),
    (9, 1, 16, 256, 2),
    (9, 100, 24, 128, 4),
    (20, 5000, 8, 384, 3),
]


def _inputs(b, v, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(v, d)).astype(np.float32))


def _numpy_contract(q, items, tc, group):
    """Per super-chunk of tc * group rows, bin l = the max over the ids with
    id % 128 == l, the first such id on ties; pad ids score PAD_SCORE."""
    scores = q.astype(np.float32) @ items.astype(np.float32).T
    b, v = scores.shape
    sup = tc * group
    vp = -(-v // sup) * sup
    s = np.concatenate([scores, np.full((b, vp - v), rt.PAD_SCORE, np.float32)], axis=1)
    s = s.reshape(b, vp // sup, sup // 128, 128)
    lane = np.arange(128)[None, None, :]
    base = (np.arange(vp // sup) * sup)[None, :, None]
    idx = base + s.argmax(axis=2) * 128 + lane
    return s.max(axis=2).reshape(b, -1), idx.reshape(b, -1).astype(np.int32)


def _port(fn, q, items, dtype, tc, group):
    vals, idx = fn(torch.from_numpy(q), torch.from_numpy(items).to(DTYPES[dtype][2]), tc, group)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    return vals.numpy(), idx.numpy()


def _jax_items(items, dtype):
    return jnp.asarray(items).astype(DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,v,d,tc,group", CASES)
def test_port_matches_jax_xla_twin(b, v, d, tc, group, dtype):
    q, items = _inputs(b, v, d, seed=b + v)
    want_vals, want_idx = jrt.bin_max_scores_xla(jnp.asarray(q), _jax_items(items, dtype),
                                                 tc=tc, group=group)
    before = rt.bin_max_scores.launches
    for fn in (rt.bin_max_scores, rt.bin_max_scores_plain):
        vals, idx = _port(fn, q, items, dtype, tc, group)
        np.testing.assert_allclose(vals, np.asarray(want_vals), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(idx, np.asarray(want_idx))
    assert rt.bin_max_scores.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("v,tc,group", [(1024, 256, 2), (1000, 256, 2), (700, 256, 4)])
def test_port_matches_pallas_interpret(v, tc, group, dtype):
    q, items = _inputs(37, v, 16, seed=9)
    want_vals, want_idx = jrt.bin_max_scores_pallas(jnp.asarray(q), _jax_items(items, dtype),
                                                    tb=16, tc=tc, group=group, interpret=True)
    vals, idx = _port(rt.bin_max_scores, q, items, dtype, tc, group)
    np.testing.assert_allclose(vals, np.asarray(want_vals), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(idx, np.asarray(want_idx))


@pytest.mark.parametrize("b,v,d,tc,group", CASES)
def test_port_matches_numpy_contract(b, v, d, tc, group):
    q, items = _inputs(b, v, d, seed=2 * b + v)
    want_vals, want_idx = _numpy_contract(q, items, tc, group)
    vals, idx = _port(rt.bin_max_scores, q, items, "f32", tc, group)
    np.testing.assert_allclose(vals, want_vals, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(idx, want_idx)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_duplicated_rows_and_pad_only_bins_take_the_lowest_id(dtype):
    """items[i] == items[i + 128] within a bin: the lower id wins, in the
    port and in JAX. V=200 in super-chunks of 512: bins 72..127 of the
    second tile hold pad ids only past the corpus; the pad-only bins
    (200..511 beyond the first tile's bins) keep their lowest pad id."""
    q, items = _inputs(11, 200, 16, seed=4)
    items[128:200] = items[0:72]
    want_vals, want_idx = jrt.bin_max_scores_xla(jnp.asarray(q), _jax_items(items, dtype),
                                                 tc=256, group=2)
    vals, idx = _port(rt.bin_max_scores, q, items, dtype, 256, 2)
    np.testing.assert_allclose(vals, np.asarray(want_vals), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(idx, np.asarray(want_idx))
    assert (idx < 128).all()  # every duplicate loses to its original; pads to valid ids
    q1, items1 = _inputs(3, 5, 16, seed=5)
    _, idx1 = _port(rt.bin_max_scores, q1, items1, dtype, 256, 2)
    np.testing.assert_array_equal(idx1, np.broadcast_to(np.arange(128, dtype=np.int32), (3, 128)))


def test_checks_raise_on_the_cpu_as_on_the_card():
    q, items = (torch.from_numpy(a) for a in _inputs(2, 300, 16, seed=6))
    with pytest.raises(TypeError):
        rt.bin_max_scores(q, items.half())
    with pytest.raises(ValueError):
        rt.bin_max_scores(q, items[:, :8])
    with pytest.raises(ValueError):
        rt.bin_max_scores(q, items, tc=200)
    with pytest.raises(ValueError):
        rt.bin_max_scores(q, items, group=0)
    vals, idx = rt.bin_max_scores(q, items[:0])
    assert vals.shape == idx.shape == (2, 0)
