"""The FM kernels against their plain versions, on the card.

Marked ``gpu``; each test skips where no card is present. On a machine with
one, run them alone (``tests/conftest.py`` imports JAX, which the card's
machine need not have):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_fm_gpu.py

Inputs are N(0, 0.01), as the framework initialises embeddings. Tolerances:
the forward within rtol 1e-5 of the terms' magnitude
``0.5 * sum_e[(sum_f v)^2 + sum_f v^2]`` plus atol 1e-7 (the result is the
difference of two positive sums, each summed in another order than torch's);
the backward and the gradient through the Function rtol 1e-5 / atol 1e-7.
"""

import numpy as np
import pytest
import torch

from pytorchrec_tpu_torch.ops.kernels import fm

SHAPES = [(1, 39, 16), (33, 39, 16), (32768, 39, 16), (33, 5, 4), (1000, 3, 1), (65, 4, 37)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy((rng.normal(size=shape) * 0.01).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.normal(size=shape[0]).astype(np.float32)).cuda()
    return v, g


def _assert_fm_close(got, want, v):
    magnitude = 0.5 * (v.sum(dim=1).square() + v.square().sum(dim=1)).sum(dim=-1)
    err = (got - want).abs()
    assert bool((err <= 1e-7 + 1e-5 * magnitude).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_kernel_matches_plain(shape):
    _need_card()
    v, _ = _inputs(shape, seed=shape[0])
    before = fm.fm_interaction.launches
    got = fm.fm_interaction(v)
    torch.cuda.synchronize()
    assert fm.fm_interaction.launches == before + 1 and tuple(got.shape) == (shape[0],)
    _assert_fm_close(got, fm.fm_interaction_plain(v), v)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernel_matches_plain(shape):
    _need_card()
    v, g = _inputs(shape, seed=shape[0] + 1)
    before = fm.fm_interaction_backward.launches
    got = fm.fm_interaction_backward(v, g)
    torch.cuda.synchronize()
    assert fm.fm_interaction_backward.launches == before + 1
    torch.testing.assert_close(got, fm.fm_interaction_backward_plain(v, g), rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 33, 32768])
def test_function_gradient_matches_plain_autograd(batch):
    """Forward and backward through the Function launch one kernel each and
    agree with autograd through the plain version."""
    _need_card()
    v, g = _inputs((batch, 39, 16), seed=batch + 2)
    before = (fm.fm_interaction.launches, fm.fm_interaction_backward.launches)
    leaf = v.clone().requires_grad_()
    out = fm.fm_interaction(leaf)
    assert type(out.grad_fn).__name__ == "FMInteractionFunctionBackward"
    out.backward(g)
    torch.cuda.synchronize()
    assert (fm.fm_interaction.launches, fm.fm_interaction_backward.launches) == (
        before[0] + 1, before[1] + 1)
    plain = v.clone().requires_grad_()
    want = fm.fm_interaction_plain(plain)
    want.backward(g)
    _assert_fm_close(out.detach(), want.detach(), v)
    torch.testing.assert_close(leaf.grad, plain.grad, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_empty_batch_launches_nothing_and_bad_inputs_raise():
    _need_card()
    before = (fm.fm_interaction.launches, fm.fm_interaction_backward.launches)
    empty = torch.zeros((0, 39, 16), device="cuda")
    assert fm.fm_interaction(empty).shape == (0,)
    assert fm.fm_interaction_backward(empty, torch.zeros(0, device="cuda")).shape == (0, 39, 16)
    assert (fm.fm_interaction.launches, fm.fm_interaction_backward.launches) == before
    with pytest.raises(TypeError):
        fm.fm_interaction(torch.zeros((4, 3, 2), device="cuda", dtype=torch.float64))
    with pytest.raises(ValueError):
        fm.fm_interaction(torch.zeros((4, 2, 3), device="cuda").transpose(1, 2))
    with pytest.raises(ValueError):
        fm.fm_interaction_backward(torch.zeros((4, 3, 2), device="cuda"), torch.zeros(4))
