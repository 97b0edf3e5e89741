"""The port's DIN attention pooling against the JAX package's, on the CPU.

The same numpy inputs and weights go through JAX's
``DINAttentionPool(use_pallas=False)`` (the XLA composite),
``din_attention_pool_pallas(..., interpret=True)`` (as
``tests/test_pallas_kernels.py`` runs the kernel) and the port's
``DINAttentionPool``, which on CPU tensors runs the plain PyTorch version.
The Pallas kernel always applies sigmoid, whatever the module's
activation, so relu is held against the XLA path alone (the port follows
it). Weights are N(0, 0.1) and the rows N(0, 1), so the scores spread and
the softmax is far from uniform.

Tolerances: the pool rtol 1e-5 / atol 1e-6 (the MLP's f32 sums run in
another order in the two frameworks; an output is a weighted sum of rows of
order 1, so 1e-6 absolute is one part in 1e6 of its terms); gradients of
``his``, ``tgt`` and every weight and bias against ``jax.grad`` rtol 1e-5 /
atol 1e-7, each weight's and bias's gradient within 1e-5 of the sum of the
absolute values of the terms it sums (``_weight_magnitudes``, in float64)
plus 1e-7. The weights need that form by the mathematics: a softmax does not
see a shift of all its scores, so the head bias's gradient is exactly 0 and
the other weights' gradients cancel, row by row, to a small part of their
terms; both frameworks then return f32 rounding noise of those terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.attention import DINAttentionPool as JaxDINAttentionPool
from pytorchrec_tpu.ops.kernels.din_attention import din_attention_pool_pallas
from pytorchrec_tpu_torch.ops import DINAttentionPool, get_position_ids, get_valid_his_index
from pytorchrec_tpu_torch.ops.kernels import din_attention as din_kernels
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu.ops.seq_utils import get_position_ids as jax_position_ids
from pytorchrec_tpu.ops.seq_utils import get_valid_his_index as jax_valid_his_index

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
# (hidden units, activation, B, N, S, E)
CASES = [
    ((16, 8), "sigmoid", 10, 3, 6, 8),
    ((8,), "sigmoid", 6, 2, 4, 8),
    ((16, 8, 4), "sigmoid", 5, 2, 5, 8),
    ((16, 8), "relu", 7, 3, 5, 8),
    ((8,), "relu", 4, 2, 3, 8),
    ((80, 40), "sigmoid", 3, 2, 20, 64),
    ((16, 8), "sigmoid", 4, 3, 1, 8),  # S=1: the forced-valid step alone
    ((16, 8), "sigmoid", 5, 1, 6, 8),  # N=1
    ((12,), "sigmoid", 3, 4, 7, 5),  # E not a multiple of 4
]


def _inputs(b, n, s, e, seed=0):
    rng = np.random.default_rng(seed)
    his = rng.normal(size=(b, s, e)).astype(np.float32)
    tgt = rng.normal(size=(b, n, e)).astype(np.float32)
    ids = rng.integers(0, 3, size=(b, s)).astype(np.int32)  # 0 = PAD
    return his, tgt, ids


def _weights(hidden, e, seed=1):
    rng = np.random.default_rng(seed)
    dims = [4 * e, *hidden, 1]
    flat = {}
    for i in range(len(dims) - 1):
        flat[f"w{i}"] = (rng.normal(size=(dims[i], dims[i + 1])) * 0.1).astype(np.float32)
        flat[f"b{i}"] = (rng.normal(size=(dims[i + 1],)) * 0.1).astype(np.float32)
    return flat


def _port_pool(hidden, activation, e, flat):
    holder = torch.nn.Module()
    holder.attention = DINAttentionPool(e, hidden, activation, device="cpu",
                                        generator=torch.Generator().manual_seed(0))
    params_from_jax({f"attention/{k}": v for k, v in flat.items()}, holder)
    return holder.attention


def _jax_pool(hidden, activation, flat, his, tgt, valid):
    module = JaxDINAttentionPool(hidden_units=hidden, activation=activation, use_pallas=False)
    params = {"params": {k: jnp.asarray(v) for k, v in flat.items()}}
    return module.apply(params, jnp.asarray(his), jnp.asarray(tgt), jnp.asarray(valid))


def _mlp(flat):
    return tuple(jnp.asarray(flat[f"{kind}{i}"]) for i in range(len(flat) // 2)
                 for kind in ("w", "b"))


def _weight_magnitudes(his, tgt, valid, flat, activation, upstream):
    """Per weight and bias, the sum over every (b, n, s) of the absolute
    terms its gradient sums, in float64: ``|x|^T |d|`` and ``sum |d|``, with
    ``x`` the layer's input and ``d`` the gradient of its pre-activation."""
    act = torch.sigmoid if activation == "sigmoid" else torch.relu
    h, t = torch.from_numpy(his).double(), torch.from_numpy(tgt).double()
    b, s, e = h.shape
    n = t.shape[1]
    hb, tb = h[:, None].expand(b, n, s, e), t[:, :, None].expand(b, n, s, e)
    x = torch.cat([hb, tb, hb - tb, hb * tb], dim=-1).requires_grad_()
    inputs, pre = [], []
    for i in range(len(flat) // 2):
        inputs.append(x)
        z = x @ torch.from_numpy(flat[f"w{i}"]).double() + torch.from_numpy(flat[f"b{i}"]).double()
        z.retain_grad()
        pre.append(z)
        x = act(z)
    masked = pre[-1][..., 0].masked_fill(torch.from_numpy(valid)[:, None, :] == 0, float("-inf"))
    out = torch.einsum("bns,bse->bne", torch.softmax(masked, dim=-1), h)
    (out * torch.from_numpy(upstream).double()).sum().backward()
    magnitudes = {}
    for i, (x, z) in enumerate(zip(inputs, pre)):
        x, d = x.detach().reshape(-1, x.shape[-1]).abs(), z.grad.reshape(-1, z.shape[-1]).abs()
        magnitudes[f"w{i}"], magnitudes[f"b{i}"] = (x.T @ d).numpy(), d.sum(dim=0).numpy()
    return magnitudes


def test_valid_mask_and_positions_match_jax():
    ids = np.array([[0, 3, 0, 2], [5, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    got = get_valid_his_index(torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_valid_his_index(jnp.asarray(ids))))
    assert got[:, 0].tolist() == [1, 1, 1]  # column 0 forced valid: PAD stands for no history
    lengths = np.array([4, 2, 5], np.int32)
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 0, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    got = get_position_ids(torch.from_numpy(valid), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_position_ids(jnp.asarray(valid), jnp.asarray(lengths))))
    assert got.tolist() == [[4, 3, 2, 1, 0], [2, 1, 0, 0, 0], [5, 4, 3, 2, 1]]


@pytest.mark.parametrize("hidden,activation,b,n,s,e", CASES)
def test_pool_matches_jax_xla_and_pallas_interpret(hidden, activation, b, n, s, e):
    his, tgt, ids = _inputs(b, n, s, e)
    valid = np.asarray(jax_valid_his_index(jnp.asarray(ids)))
    flat = _weights(hidden, e)
    pool = _port_pool(hidden, activation, e, flat)
    before = din_kernels.din_attention_pool.launches
    with torch.no_grad():
        got = pool(torch.from_numpy(his), torch.from_numpy(tgt), torch.from_numpy(valid)).numpy()
    assert din_kernels.din_attention_pool.launches == before  # CPU: the plain version
    assert got.shape == (b, n, e)
    want = np.asarray(_jax_pool(hidden, activation, flat, his, tgt, valid))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if activation == "sigmoid":  # the Pallas kernel applies sigmoid whatever it is given
        kernel = din_attention_pool_pallas(jnp.asarray(his), jnp.asarray(tgt), jnp.asarray(valid),
                                           _mlp(flat), block_b=8, interpret=True)
        np.testing.assert_allclose(got, np.asarray(kernel), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden,activation,b,n,s,e", CASES)
def test_gradients_match_jax_grad(hidden, activation, b, n, s, e):
    """Gradients of his, tgt and every weight and bias through the port's
    Function against ``jax.grad`` of the XLA composite and, for sigmoid, of
    the Pallas kernel's custom VJP."""
    his, tgt, ids = _inputs(b, n, s, e, seed=2)
    valid = np.asarray(jax_valid_his_index(jnp.asarray(ids)))
    upstream = np.random.default_rng(3).normal(size=(b, n, e)).astype(np.float32)
    flat = _weights(hidden, e, seed=4)
    pool = _port_pool(hidden, activation, e, flat)
    his_t = torch.from_numpy(his).requires_grad_()
    tgt_t = torch.from_numpy(tgt).requires_grad_()
    out = pool(his_t, tgt_t, torch.from_numpy(valid))
    assert type(out.grad_fn).__name__ == "DINAttentionFunctionBackward"
    out.backward(torch.from_numpy(upstream))
    got = {"his": his_t.grad, "tgt": tgt_t.grad}
    got.update({k: getattr(pool, k).grad for k in flat})

    def loss_xla(h, t, weights):
        return jnp.sum(_jax_pool(hidden, activation, weights, h, t, valid) * upstream)

    def loss_kernel(h, t, weights):
        out = din_attention_pool_pallas(h, t, jnp.asarray(valid), _mlp(weights), block_b=8,
                                        interpret=True)
        return jnp.sum(out * upstream)

    args = (jnp.asarray(his), jnp.asarray(tgt), {k: jnp.asarray(v) for k, v in flat.items()})
    losses = [loss_xla] + ([loss_kernel] if activation == "sigmoid" else [])
    magnitudes = _weight_magnitudes(his, tgt, valid, flat, activation, upstream)
    for loss in losses:
        dh, dt, dw = jax.grad(loss, argnums=(0, 1, 2))(*args)
        for name, value in (("his", dh), ("tgt", dt)):
            np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)
        for name, value in dw.items():
            err = np.abs(got[name].numpy() - np.asarray(value))
            assert (err <= GRAD_RTOL * magnitudes[name] + GRAD_ATOL).all(), (name, err.max())


def test_two_dimensional_target_squeezes():
    his, tgt, ids = _inputs(6, 1, 5, 8, seed=5)
    valid = get_valid_his_index(torch.from_numpy(ids))
    flat = _weights((16, 8), 8)
    pool = _port_pool((16, 8), "sigmoid", 8, flat)
    with torch.no_grad():
        got = pool(torch.from_numpy(his), torch.from_numpy(tgt[:, 0]), valid)
        want = pool(torch.from_numpy(his), torch.from_numpy(tgt), valid)[:, 0]
    assert tuple(got.shape) == (6, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jax_want = _jax_pool((16, 8), "sigmoid", flat, his, tgt[:, 0], valid.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), rtol=RTOL, atol=ATOL)


def test_a_row_with_no_valid_step_gives_nan_as_jax():
    his, tgt, _ = _inputs(3, 2, 4, 8, seed=6)
    valid = np.ones((3, 4), np.int32)
    valid[1] = 0  # DIN never makes such a row (column 0 is forced valid)
    flat = _weights((8,), 8)
    pool = _port_pool((8,), "sigmoid", 8, flat)
    with torch.no_grad():
        got = pool(torch.from_numpy(his), torch.from_numpy(tgt), torch.from_numpy(valid)).numpy()
    want = np.asarray(_jax_pool((8,), "sigmoid", flat, his, tgt, valid))
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=RTOL, atol=ATOL)


def test_plain_version_is_the_formula():
    """Against a per-(b, n) loop in float64: features, MLP, masked softmax,
    weighted sum."""
    his, tgt, ids = _inputs(3, 2, 5, 4, seed=7)
    valid = get_valid_his_index(torch.from_numpy(ids))
    flat = _weights((6, 3), 4)
    params = [torch.from_numpy(flat[f"{kind}{i}"]).double() for i in range(3) for kind in "wb"]
    got = din_kernels.din_attention_pool_plain(torch.from_numpy(his).double(),
                                               torch.from_numpy(tgt).double(), valid, params)
    h64, t64 = torch.from_numpy(his).double(), torch.from_numpy(tgt).double()
    for b in range(3):
        for n in range(2):
            scores = []
            for s in range(5):
                x = torch.cat([h64[b, s], t64[b, n], h64[b, s] - t64[b, n], h64[b, s] * t64[b, n]])
                for i in range(2):
                    x = torch.sigmoid(x @ params[2 * i] + params[2 * i + 1])
                z = float(x @ params[4] + params[5])
                scores.append(z if valid[b, s] else -np.inf)
            weights = torch.softmax(torch.tensor(scores, dtype=torch.float64), dim=0)
            torch.testing.assert_close(got[b, n], weights @ h64[b])


def test_grad_goes_through_the_function_only_when_needed():
    his, tgt, ids = _inputs(4, 2, 3, 8, seed=8)
    valid = get_valid_his_index(torch.from_numpy(ids))
    pool = _port_pool((8,), "sigmoid", 8, _weights((8,), 8))
    his_t, tgt_t = torch.from_numpy(his), torch.from_numpy(tgt)
    with torch.no_grad():
        assert pool(his_t, tgt_t, valid).grad_fn is None
    # weights alone need a gradient: his and tgt get none, every weight one
    out = pool(his_t, tgt_t, valid)
    assert type(out.grad_fn).__name__ == "DINAttentionFunctionBackward"
    out.sum().backward()
    assert his_t.grad is None and all(p.grad is not None for p in pool.parameters())
    plain = [p.detach().clone().requires_grad_() for p in pool.mlp_params()]
    din_kernels.din_attention_pool_plain(his_t, tgt_t, valid, plain).sum().backward()
    for p, q in zip(pool.mlp_params(), plain):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-6, atol=1e-8)


def test_empty_batch_gives_an_empty_result():
    pool = _port_pool((8,), "sigmoid", 4, _weights((8,), 4))
    for b, n in ((0, 2), (3, 0)):
        his = torch.zeros((b, 3, 4), requires_grad=True)
        tgt = torch.zeros((b, n, 4), requires_grad=True)
        out = pool(his, tgt, torch.ones((b, 3), dtype=torch.int32))
        assert tuple(out.shape) == (b, n, 4)
        out.sum().backward()
        assert tuple(his.grad.shape) == (b, 3, 4)


@pytest.mark.parametrize("case", ["float64", "strided", "valid_dtype", "valid_shape", "w_shape",
                                  "odd_params", "no_hidden", "activation", "no_steps",
                                  "mixed_devices"])
def test_op_rejects_what_the_kernel_does_not_take(case):
    his, tgt = torch.zeros((4, 3, 2)), torch.zeros((4, 2, 2))
    valid = torch.ones((4, 3), dtype=torch.int32)
    params = [torch.zeros((8, 5)), torch.zeros(5), torch.zeros((5, 1)), torch.zeros(1)]
    activation = "sigmoid"
    if case == "float64":
        his = his.double()
    elif case == "strided":
        tgt = torch.zeros((4, 2, 2)).transpose(1, 2)
    elif case == "valid_dtype":
        valid = valid.bool()
    elif case == "valid_shape":
        valid = valid[:, :2].contiguous()
    elif case == "w_shape":
        params[0] = torch.zeros((7, 5))
    elif case == "odd_params":
        params = params[:3]
    elif case == "no_hidden":
        params = [torch.zeros((8, 1)), torch.zeros(1)]
    elif case == "activation":
        activation = "tanh"
    elif case == "no_steps":
        his, valid = torch.zeros((4, 0, 2)), torch.ones((4, 0), dtype=torch.int32)
    else:
        valid = torch.ones((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises((TypeError, ValueError)):
        din_kernels.din_attention_pool(his, tgt, valid, params, activation)
