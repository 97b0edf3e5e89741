"""Equal item rows in retrieval on the CPU: they score equal bits, and the
lower id wins a bin and ranks first, in the port's plain bin max
(``bin_max_scores_plain``, B7's plain version) and in its exact path, as in
the JAX package.

The corpus is N(0, 1) from a numpy seed with a few rows copied to other
positions: inside one super-chunk (the same bin, and the next column),
across super-chunks and into the ragged tail. (PyTorch 2.13's CPU GEMM gives
a row at column 128 or past it of a 200-column product other bits than the
same row below 128; 200-row chunks are among the cases.) The copied rows are scaled by
3 first, so that they win their bins and the top of the ranking for most
queries and the ties decide the answer. Tolerance: against JAX, vals and
scores rtol 1e-5 / atol 1e-6 (f32 sums of D products in another order),
ids equal; against float64 dot products, the error bound of a sum of D
rounded terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.kernels import retrieval_topk as jrt
from pytorchrec_tpu.serving import retrieval as jret
from pytorchrec_tpu_torch.ops.kernels import retrieval_topk as rt
from pytorchrec_tpu_torch.serving import retrieval

RTOL, ATOL = 1e-5, 1e-6
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TC, GROUP = 256, 2  # super-chunks of 512 rows
# (V, D, [(original, copy), ...])
CASES = {
    "one super-chunk": (200, 16, [(3, 131), (10, 138), (60, 188), (40, 41)]),
    "one full super-chunk": (500, 16, [(3, 131), (3, 259), (10, 394), (40, 41)]),
    "across super-chunks": (1100, 24, [(0, 512), (7, 647), (130, 1026), (200, 201)]),
    "into the tail": (712, 16, [(515, 643), (530, 658), (3, 700), (600, 711)]),
    "V = one bin of copies": (128 * 5, 8, [(1, 129), (1, 257), (1, 385), (1, 513)]),
    "a block of copies": (200, 16, [(i, 128 + i) for i in range(72)]),
}


def _inputs(v, d, pairs, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(9, d)).astype(np.float32)
    items = rng.normal(size=(v, d)).astype(np.float32)
    for src, _ in pairs:
        items[src] *= 3.0
    for src, dst in pairs:
        items[dst] = items[src]
    return q, items


def _same_bin(src, dst):
    sup = TC * GROUP
    return src // sup == dst // sup and src % rt.LANES == dst % rt.LANES


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_equal_rows_score_equal_bits(case, dtype):
    v, d, pairs = CASES[case]
    q, items = _inputs(v, d, pairs, seed=v + d)
    port_items = torch.from_numpy(items).to(DTYPES[dtype][1])
    scores = rt.ordered_scores(torch.from_numpy(q).to(port_items.dtype), port_items)
    assert scores.dtype == torch.float32 and scores.shape == (9, v)
    for src, dst in pairs:
        assert torch.equal(scores[:, src], scores[:, dst]), (src, dst)
    # within the bound of a sum of D rounded terms, D * 2**-24 * sum |q_d x_d|,
    # of the float64 dot products of the same (cast) values
    q_cast = torch.from_numpy(q).to(port_items.dtype).double().numpy()
    x = port_items.double().numpy()
    bound = d * 2.0**-24 * (np.abs(q_cast) @ np.abs(x).T)
    assert (np.abs(scores.numpy() - q_cast @ x.T) <= bound).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_bin_max_takes_the_lowest_id_as_jax(case, dtype):
    v, d, pairs = CASES[case]
    q, items = _inputs(v, d, pairs, seed=v + d)
    jax_dtype, torch_dtype = DTYPES[dtype]
    want_vals, want_idx = jrt.bin_max_scores_xla(
        jnp.asarray(q), jnp.asarray(items).astype(jax_dtype), tc=TC, group=GROUP)
    vals, idx = rt.bin_max_scores_plain(
        torch.from_numpy(q), torch.from_numpy(items).to(torch_dtype), TC, GROUP)
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    idx = idx.numpy()
    for src, dst in pairs:
        if _same_bin(src, dst):
            assert not (idx == dst).any(), (src, dst)
            assert (idx == src).any(), (src, dst)  # the scaled row wins its bin somewhere


@pytest.mark.parametrize("chunk", [1 << 30, 256, 300])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_exact_path_ranks_the_lower_id_first_as_jax(case, dtype, chunk):
    """One chunk, equal chunks and a ragged last chunk, so copies meet in
    one chunk's top-k and in the running merge."""
    v, d, pairs = CASES[case]
    q, items = _inputs(v, d, pairs, seed=v + d)
    jax_dtype, torch_dtype = DTYPES[dtype]
    k = 2 * len(pairs) + 3
    want_s, want_i = jret._topk_scores(jnp.asarray(q), jnp.asarray(items).astype(jax_dtype), k,
                                       None, chunk)
    got_s, got_i = retrieval._topk_scores(torch.from_numpy(q),
                                          torch.from_numpy(items).to(torch_dtype), k, None, chunk)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL, atol=ATOL)
    ranked = got_i.numpy()
    for src, dst in pairs:
        for row in ranked:
            hits = list(row)
            if dst in hits:
                assert src in hits and hits.index(src) < hits.index(dst), (src, dst, hits)
