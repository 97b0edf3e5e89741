"""The split form of the DIN pool's first layer against the concat form, on the CPU.

The pooling kernel (``csrc/din_attention.cu``) does not form the features
``[h, t, h - t, h * t]``: since ``[h, t, h - t, h * t] w_0 = h (w_a + w_c) +
t (w_b - w_c) + (h * t) w_d`` (``w_0``'s four row blocks), it forms
``w_h = w_a + w_c`` and ``w_t = w_b - w_c`` in f32 as it loads them, the t
part plus ``b_0`` once a (b, n) row, and ``h w_h + (h * t) w_d`` per pair.
``split_pool`` below is that regrouping in torch; the same numpy inputs go
through it, through JAX's XLA composite (``_din_xla``, which applies sigmoid;
for relu the XLA path of ``DINAttentionPool``) and through the port's plain
version, at ``tests/test_torch_din_attention.py``'s shapes, at DIN's scale
(rows and weights N(0, 0.01)) and a spread one (rows N(0, 1), weights
N(0, 0.1)), with candidates drawn apart from the history and equal to
history rows (``h - t`` exactly 0 in the concat form).

Tolerance rtol 1e-5 / atol 1e-7: the regrouping moves f32 sums by last
bits, well under the rtol 1e-4 / atol 1e-6 at which the card holds the
kernel to the plain version.

The split form keeps each tile row's t part in shared memory, so the
wrapper's planner (``tile_plan``, plain Python) gives a tile fewer rows
than fill a chunk where a whole chunk's rows would not fit: the last tests
hold it, at the H100's 232,448 bytes a block, to the rows it picks, to its
raises, and to fitting every shape that the concat form's layout (all of
``w_0``, no t parts) fitted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.attention import DINAttentionPool as JaxDINAttentionPool
from pytorchrec_tpu.ops.kernels.din_attention import _din_xla
from pytorchrec_tpu_torch.ops.kernels.din_attention import (CHUNK, din_attention_pool_plain,
                                                            smem_bytes, tile_plan)

RTOL, ATOL = 1e-5, 1e-7
# (hidden units, activation, B, N, S, E): tests/test_torch_din_attention.py's CASES
CASES = [
    ((16, 8), "sigmoid", 10, 3, 6, 8),
    ((8,), "sigmoid", 6, 2, 4, 8),
    ((16, 8, 4), "sigmoid", 5, 2, 5, 8),
    ((16, 8), "relu", 7, 3, 5, 8),
    ((8,), "relu", 4, 2, 3, 8),
    ((80, 40), "sigmoid", 3, 2, 20, 64),
    ((16, 8), "sigmoid", 4, 3, 1, 8),
    ((16, 8), "sigmoid", 5, 1, 6, 8),
    ((12,), "sigmoid", 3, 4, 7, 5),
]


def split_pool(his, tgt, valid, params, activation):
    """The kernel's arithmetic: layer 0 as ``u + h w_h + (h * t) w_d`` with
    ``u = b_0 + t w_t`` once a (b, n) row; the rest as the plain version."""
    act = torch.sigmoid if activation == "sigmoid" else torch.relu
    e = his.shape[-1]
    w_0, b_0 = params[0], params[1]
    w_a, w_b, w_c, w_d = (w_0[k * e:(k + 1) * e] for k in range(4))
    w_h, w_t = w_a + w_c, w_b - w_c
    u = b_0 + tgt @ w_t  # [B, N, H_1]
    h = his[:, None, :, :]
    ht = h * tgt[:, :, None, :]
    h, ht = torch.broadcast_tensors(h, ht)
    a = act(torch.cat([h, ht], dim=-1) @ torch.cat([w_h, w_d]) + u[:, :, None, :])
    for i in range(1, len(params) // 2 - 1):
        a = act(a @ params[2 * i] + params[2 * i + 1])
    scores = (a @ params[-2] + params[-1])[..., 0]
    scores = scores.masked_fill(valid[:, None, :] == 0, float("-inf"))
    return torch.einsum("bns,bse->bne", torch.softmax(scores, dim=-1), his)


def _inputs(hidden, b, n, s, e, scale, equal_rows, seed):
    rng = np.random.default_rng(seed)
    row, weight = (0.01, 0.01) if scale == "din" else (1.0, 0.1)
    his = (rng.normal(size=(b, s, e)) * row).astype(np.float32)
    tgt = (rng.normal(size=(b, n, e)) * row).astype(np.float32)
    if equal_rows:
        tgt = his[:, np.arange(n) % s].copy()
    valid = rng.integers(0, 2, size=(b, s)).astype(np.int32)
    valid[:, 0] = 1
    dims = [4 * e, *hidden, 1]
    params = []
    for i in range(len(dims) - 1):
        params += [(rng.normal(size=(dims[i], dims[i + 1])) * weight).astype(np.float32),
                   (rng.normal(size=(dims[i + 1],)) * weight).astype(np.float32)]
    return his, tgt, valid, params


def _jax(hidden, activation, his, tgt, valid, params):
    if activation == "sigmoid":
        return np.asarray(_din_xla(jnp.asarray(his), jnp.asarray(tgt), jnp.asarray(valid),
                                   tuple(jnp.asarray(p) for p in params)))
    module = JaxDINAttentionPool(hidden_units=hidden, activation=activation, use_pallas=False)
    flat = {f"{kind}{i // 2}": jnp.asarray(p) for i, (kind, p) in
            enumerate(zip("wb" * (len(params) // 2), params))}
    return np.asarray(module.apply({"params": flat}, jnp.asarray(his), jnp.asarray(tgt),
                                   jnp.asarray(valid)))


@pytest.mark.parametrize("equal_rows", [False, True], ids=["apart", "equal_rows"])
@pytest.mark.parametrize("scale", ["din", "spread"])
@pytest.mark.parametrize("hidden,activation,b,n,s,e", CASES)
def test_split_form_matches_jax_and_plain(hidden, activation, b, n, s, e, scale, equal_rows):
    his, tgt, valid, params = _inputs(hidden, b, n, s, e, scale, equal_rows, seed=b + n + s + e)
    torch_args = [torch.from_numpy(x) for x in (his, tgt, valid)]
    torch_params = [torch.from_numpy(p) for p in params]
    got = split_pool(*torch_args, torch_params, activation).numpy()
    assert got.shape == (b, n, e) and np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(hidden, activation, his, tgt, valid, params),
                               rtol=RTOL, atol=ATOL)
    plain = din_attention_pool_plain(*torch_args, torch_params, activation).numpy()
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)


H100_SMEM = 232_448  # shared memory a block may opt in to on the H100 (227 KB)


def _concat_layout_bytes(e, s, hidden):
    """A block's shared memory in the concat form's layout: all of ``w_0``,
    no t parts, a chunk's worth of rows."""
    dims = [4 * e, *hidden, 1]
    weights = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    rows = CHUNK // s if s < CHUNK else 1
    return 4 * (weights + CHUNK * e + rows * e + 2 * CHUNK * max(hidden) + rows * s)


@pytest.mark.parametrize("e,s,hidden,rows,nbytes", [
    (64, 20, (80, 40), 6, 193_520),  # DIN's shapes
    (64, 129, (80, 40), 1, 190_676),
    (16, 20, (150, 40), 6, 219_984),
    (8, 6, (16, 8), 21, 25_192),
])
def test_tile_plan_fills_a_chunk_where_it_fits(e, s, hidden, rows, nbytes):
    assert tile_plan(e, s, hidden, H100_SMEM) == (rows, nbytes)
    assert smem_bytes(e, s, hidden, rows) == nbytes


@pytest.mark.parametrize("e,s,hidden", [(8, 1, (160, 40)), (8, 2, (160, 40)), (8, 1, (200,)),
                                        (1, 1, (220,))])
def test_tile_plan_takes_fewer_rows_where_a_chunk_would_not_fit(e, s, hidden):
    plan = tile_plan(e, s, hidden, H100_SMEM)
    assert 1 <= plan.rows < CHUNK // s
    assert plan.smem_bytes == smem_bytes(e, s, hidden, plan.rows) <= H100_SMEM
    assert smem_bytes(e, s, hidden, plan.rows + 1) > H100_SMEM


@pytest.mark.parametrize("e", [1, 8, 16, 40, 64, 96])
def test_every_shape_the_concat_layout_fitted_still_fits(e):
    fitted = 0
    for s in (1, 2, 3, 6, 20, 64, 129, 8192):
        for hidden in [(1,), (8,), (80, 40), (40, 160), (64, 32), (150, 40), (160, 40), (200,),
                       (220,), (256,), (16, 8, 4)]:
            if _concat_layout_bytes(e, s, hidden) > H100_SMEM:
                continue
            fitted += 1
            plan = tile_plan(e, s, hidden, H100_SMEM)
            assert plan.smem_bytes <= H100_SMEM, (s, hidden)
    assert fitted > 0


@pytest.mark.parametrize("e,s,hidden", [(8, 5, (256,)), (8, 5, (8,) * 8), (8, 8193, (8,)),
                                        (8, 0, (8,)), (8, 5, ())])
def test_tile_plan_raises_outside_the_kernels_limits(e, s, hidden):
    with pytest.raises(ValueError):
        tile_plan(e, s, hidden, H100_SMEM)
