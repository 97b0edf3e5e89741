"""The port's FM interaction against the JAX package's, on the CPU.

The same numpy field vectors go through the JAX ``fm_interaction`` (XLA),
``fm_interaction_pallas(..., block_b=32, interpret=True)`` (as
``tests/test_pallas_kernels.py`` runs the kernel) and the port's
``fm_interaction``, which on CPU tensors runs the plain PyTorch version.
Vectors are N(0, 0.01) as the framework initialises embeddings, so the
result is orders of magnitude smaller than either of its two sums.

Tolerances: the forward within rtol 1e-5 of the terms' magnitude
``0.5 * sum_e[(sum_f v)^2 + sum_f v^2]`` plus atol 1e-7 (the difference of
two positive sums cancels, and f32 sums run in another order in the two
frameworks); the gradient ``g * (sum_f v - v)`` rtol 1e-5 / atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.interactions import fm_interaction as jax_fm
from pytorchrec_tpu.ops.interactions import fm_interaction_vector as jax_fm_vector
from pytorchrec_tpu.ops.kernels.fm import fm_interaction_pallas
from pytorchrec_tpu_torch.ops.interactions import fm_interaction, fm_interaction_vector
from pytorchrec_tpu_torch.ops.kernels import fm as fm_kernels

RTOL, ATOL = 1e-5, 1e-7
SHAPES = [(1, 5, 4), (33, 5, 4), (100, 26, 16), (7, 39, 16), (65, 3, 1), (9, 4, 37)]


def _vectors(shape, seed=0, scale=0.01):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _magnitude(v):
    """``0.5 * sum_e[(sum_f v)^2 + sum_f v^2]`` over the last two axes."""
    v = v.astype(np.float64)
    return 0.5 * (np.square(v.sum(axis=-2)) + np.square(v).sum(axis=-2)).sum(axis=-1)


def _assert_fm_close(got, want, v):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = ATOL + RTOL * _magnitude(v)
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _no_launches():
    return fm_kernels.fm_interaction.launches, fm_kernels.fm_interaction_backward.launches


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_xla_and_pallas_interpret(shape):
    v = _vectors(shape)
    before = _no_launches()
    got = fm_interaction(torch.from_numpy(v)).numpy()
    assert _no_launches() == before  # CPU tensors run the plain version
    _assert_fm_close(got, jax_fm(jnp.asarray(v)), v)
    _assert_fm_close(got, fm_interaction_pallas(jnp.asarray(v), block_b=32, interpret=True), v)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_jax_grad_of_xla_and_pallas(shape):
    """The Function's backward for an upstream gradient ``g`` against
    ``jax.grad`` through the XLA op and through the kernel's custom VJP."""
    v = _vectors(shape, seed=1)
    g = np.random.default_rng(2).normal(size=shape[0]).astype(np.float32)
    leaf = torch.from_numpy(v).requires_grad_()
    out = fm_interaction(leaf)
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "FMInteractionFunctionBackward"
    before = _no_launches()
    out.backward(torch.from_numpy(g))
    assert _no_launches() == before
    for fn in (jax_fm, lambda x: fm_interaction_pallas(x, block_b=32, interpret=True)):
        want = jax.grad(lambda x: jnp.sum(fn(x) * g))(jnp.asarray(v))
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_candidate_lead_dims_flatten_and_return_in_shape():
    v = _vectors((4, 7, 6, 3), seed=3)
    got = fm_interaction(torch.from_numpy(v))
    assert tuple(got.shape) == (4, 7)
    _assert_fm_close(got.numpy(), jax_fm(jnp.asarray(v)), v)
    # a non-contiguous candidate tensor (a broadcast user side) is copied first
    user = torch.from_numpy(_vectors((4, 1, 6, 3), seed=4)).expand(4, 7, 6, 3)
    _assert_fm_close(fm_interaction(user).numpy(), jax_fm(jnp.asarray(user.numpy())),
                     user.numpy())


def test_candidate_gradient_matches_jax():
    v = _vectors((3, 5, 6, 4), seed=5)
    g = np.random.default_rng(6).normal(size=(3, 5)).astype(np.float32)
    leaf = torch.from_numpy(v).requires_grad_()
    fm_interaction(leaf).backward(torch.from_numpy(g))
    want = jax.grad(lambda x: jnp.sum(jax_fm(x) * g))(jnp.asarray(v))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_vector_interaction_matches_jax():
    v = _vectors((11, 6, 5), seed=7)
    got = fm_interaction_vector(torch.from_numpy(v)).numpy()
    assert got.shape == (11, 5)
    bound = ATOL + RTOL * 0.5 * (np.square(v.sum(axis=-2)) + np.square(v).sum(axis=-2))
    assert (np.abs(got - np.asarray(jax_fm_vector(jnp.asarray(v)))) <= bound).all()
    torch.testing.assert_close(torch.from_numpy(got).sum(dim=-1),
                               fm_interaction(torch.from_numpy(v)), rtol=1e-5, atol=1e-7)


def test_plain_versions_are_the_formulas():
    v = torch.from_numpy(_vectors((5, 4, 3), seed=8, scale=1.0)).double()
    pairs = sum((v[:, i] * v[:, j]).sum(dim=-1) for i in range(4) for j in range(i + 1, 4))
    torch.testing.assert_close(fm_kernels.fm_interaction_plain(v), pairs)
    g = torch.arange(5, dtype=torch.float64)
    want = torch.stack([g[b] * (v[b].sum(dim=0) - v[b]) for b in range(5)])
    torch.testing.assert_close(fm_kernels.fm_interaction_backward_plain(v, g), want)


def test_grad_goes_through_the_function_only_when_needed():
    v = torch.from_numpy(_vectors((6, 3, 2), seed=9))
    assert fm_kernels.fm_interaction(v).grad_fn is None
    with torch.no_grad():
        assert fm_kernels.fm_interaction(v.requires_grad_()).grad_fn is None
    # the Function's gradient equals autograd through the plain version
    g = torch.from_numpy(np.random.default_rng(10).normal(size=6).astype(np.float32))
    plain = v.detach().clone().requires_grad_()
    fm_kernels.fm_interaction_plain(plain).backward(g)
    fm_kernels.fm_interaction(v).backward(g)
    torch.testing.assert_close(v.grad, plain.grad, rtol=1e-5, atol=1e-7)


def test_empty_batch_gives_an_empty_result():
    for shape in ((0, 4, 3), (5, 0, 3)):
        v = torch.zeros(shape, requires_grad=True)
        out = fm_kernels.fm_interaction(v)
        assert tuple(out.shape) == (shape[0],) and not out.any()
        out.sum().backward()
        assert tuple(v.grad.shape) == shape


@pytest.mark.parametrize("case", ["2d", "4d", "float64", "strided", "g_shape", "g_dtype",
                                  "g_strided", "mixed_devices"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    v = torch.zeros((4, 3, 2))
    g = torch.zeros(4)
    if case == "2d":
        v = torch.zeros((4, 6))
    elif case == "4d":
        v = torch.zeros((2, 4, 3, 2))
    elif case == "float64":
        v = v.double()
    elif case == "strided":
        v = torch.zeros((4, 2, 3)).transpose(1, 2)
    elif case == "g_shape":
        g = torch.zeros(5)
    elif case == "g_dtype":
        g = g.double()
    elif case == "g_strided":
        g = torch.zeros(8)[::2]
    else:
        g = torch.zeros(4, device="meta")
    with pytest.raises((TypeError, ValueError)):
        if case.startswith("g") or case == "mixed_devices":
            fm_kernels.fm_interaction_backward(v, g)
        else:
            fm_kernels.fm_interaction(v)
