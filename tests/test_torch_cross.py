"""The port's cross network against the JAX package's, on the CPU.

The same numpy inputs go through ``cross_network_pallas`` (interpret mode),
the flax ``CrossNetworkV2`` (its XLA layer loop) and the port's
``cross_network`` / ``CrossNetworkV2``, which on CPU tensors run the plain
PyTorch version. Weights are drawn at the framework's init scale, N(0, 0.01).
Tolerance rtol 1e-5 / atol 1e-7: the f32 sums of D terms run in another
order in the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorchrec_tpu.ops.interactions import CrossNetworkV2 as JaxCrossNetworkV2
from pytorchrec_tpu.ops.kernels.cross import cross_network_pallas
from pytorchrec_tpu_torch.ops.interactions import CrossNetworkV2, cross_layer_v2
from pytorchrec_tpu_torch.ops.kernels import launches_kernel
from pytorchrec_tpu_torch.ops.kernels.cross import cross_network, cross_network_plain

RTOL, ATOL = 1e-5, 1e-7
CASES = [(37, d, layers) for d in (29, 64) for layers in (0, 1, 3)]


def _inputs(batch, dim, layers, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(batch, dim)).astype(np.float32)
    ws = (rng.normal(size=(layers, dim, dim)) * 0.01).astype(np.float32)
    bs = (rng.normal(size=(layers, dim)) * 0.01).astype(np.float32)
    return x0, ws, bs


def _port(x0, ws, bs):
    before = cross_network.launches
    out = cross_network(*(torch.from_numpy(a) for a in (x0, ws, bs)))
    assert cross_network.launches == before  # CPU tensors never launch the kernel
    return out.numpy()


@pytest.mark.parametrize("batch,dim,layers", CASES)
def test_plain_cross_matches_pallas_interpret(batch, dim, layers):
    x0, ws, bs = _inputs(batch, dim, layers)
    if layers == 0:
        want = x0  # the JAX module's identity; the kernel needs at least one layer
    else:
        want = np.asarray(cross_network_pallas(jnp.asarray(x0), jnp.asarray(ws),
                                               jnp.asarray(bs), interpret=True))
    np.testing.assert_allclose(_port(x0, ws, bs), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch,dim,layers", CASES)
def test_plain_cross_matches_xla_layer_loop(batch, dim, layers):
    x0, ws, bs = _inputs(batch, dim, layers, seed=1)
    module = JaxCrossNetworkV2(num_layers=layers, use_pallas=False)
    params = {"params": {"ws": jnp.asarray(ws), "bs": jnp.asarray(bs)}} if layers else {}
    want = np.asarray(module.apply(params, jnp.asarray(x0)))
    np.testing.assert_allclose(_port(x0, ws, bs), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layers", [0, 2])
def test_cross_module_candidate_mode_matches_flax(layers):
    """[B, N, D] input flattens to [B*N, D] and comes back in shape."""
    dim = 12
    x0, ws, bs = _inputs(5 * 7, dim, layers, seed=2)
    x0 = x0.reshape(5, 7, dim)
    module = JaxCrossNetworkV2(num_layers=layers, use_pallas=False)
    params = {"params": {"ws": jnp.asarray(ws), "bs": jnp.asarray(bs)}} if layers else {}
    want = np.asarray(module.apply(params, jnp.asarray(x0)))
    port = CrossNetworkV2(layers, dim, device="cpu", generator=torch.Generator().manual_seed(0))
    if layers:
        port.load_state_dict({"ws": torch.from_numpy(ws), "bs": torch.from_numpy(bs)})
    else:
        assert not list(port.parameters())
    with torch.no_grad():
        got = port(torch.from_numpy(x0)).numpy()
    assert got.shape == (5, 7, dim)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_version_is_the_layer_loop():
    x0, ws, bs = (torch.from_numpy(a) for a in _inputs(9, 6, 2, seed=3))
    xl = x0
    for layer in range(2):
        xl = cross_layer_v2(x0, xl, ws[layer], bs[layer])
    torch.testing.assert_close(cross_network_plain(x0, ws, bs), xl, rtol=0, atol=0)


def test_dispatch_rule():
    cpu = torch.zeros(2, 2)
    assert launches_kernel(cpu, cpu) is False
    meta = torch.zeros(2, 2, device="meta")
    with pytest.raises(ValueError):
        launches_kernel(meta)  # neither a card nor the CPU: no silent plain version
    with pytest.raises(ValueError):
        launches_kernel(cpu, meta)


@pytest.mark.parametrize("shapes", [
    ((4, 6), (2, 6, 5), (2, 6)),   # W not square
    ((4, 6), (2, 6, 6), (3, 6)),   # bs layers differ
    ((4, 6), (6, 6), (6,)),        # unstacked weights
])
def test_wrapper_rejects_bad_shapes(shapes):
    x0, ws, bs = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        cross_network(x0, ws, bs)


GRAD_CASES = [(37, d, layers) for d in (29, 64) for layers in (1, 3)]


def _upstream(batch, dim, seed):
    return np.random.default_rng(seed).normal(size=(batch, dim)).astype(np.float32)


def _assert_grads_close(got, want):
    """rtol 1e-5; an element that cancels to near zero keeps the absolute
    f32 error of its largest terms, so atol is 1e-6 of the tensor's largest
    element (the grads here reach ~10)."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * float(np.abs(w).max()))


def _port_grads(x0, ws, bs, g):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x0, ws, bs)]
    out = cross_network(*leaves)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("batch,dim,layers", GRAD_CASES)
def test_function_grads_match_pallas_custom_vjp(batch, dim, layers):
    """The Function's backward against ``jax.grad`` through the kernel's
    custom VJP (interpret mode), for the upstream gradient ``g``."""
    x0, ws, bs = _inputs(batch, dim, layers, seed=4)
    g = _upstream(batch, dim, seed=5)

    def loss(x0, ws, bs):
        return jnp.sum(cross_network_pallas(x0, ws, bs, interpret=True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x0, ws, bs)))
    _assert_grads_close(_port_grads(x0, ws, bs, g), want)


@pytest.mark.parametrize("batch,dim,layers", GRAD_CASES)
def test_function_grads_match_autograd_of_the_xla_loop(batch, dim, layers):
    """The same against ``jax.grad`` of the flax module's XLA layer loop."""
    x0, ws, bs = _inputs(batch, dim, layers, seed=6)
    g = _upstream(batch, dim, seed=7)
    module = JaxCrossNetworkV2(num_layers=layers, use_pallas=False)

    def loss(x0, ws, bs):
        return jnp.sum(module.apply({"params": {"ws": ws, "bs": bs}}, x0) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x0, ws, bs)))
    _assert_grads_close(_port_grads(x0, ws, bs, g), want)


def test_grad_goes_through_the_function_only_when_needed():
    x0, ws, bs = (torch.from_numpy(a) for a in _inputs(5, 6, 2, seed=8))
    assert cross_network(x0, ws, bs).grad_fn is None
    out = cross_network(x0, ws.requires_grad_(), bs)
    assert type(out.grad_fn).__name__ == "CrossNetworkFunctionBackward"
    with torch.no_grad():
        assert cross_network(x0, ws, bs).grad_fn is None
    # the plain version under autograd gives the same gradient
    g = torch.from_numpy(_upstream(5, 6, seed=9))
    plain_ws = ws.detach().clone().requires_grad_()
    cross_network_plain(x0, plain_ws, bs).backward(g)
    out.backward(g)
    torch.testing.assert_close(ws.grad, plain_ws.grad, rtol=1e-5, atol=1e-7)
