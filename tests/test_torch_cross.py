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
from pytorchrec_tpu_torch.ops.kernels.cross import (
    FUSED_MAX_WIDTH,
    K_TILE,
    MAX_SLICES,
    ROW_TILE,
    SM_COUNT,
    SPLIT_MAX_WAVES,
    TILES,
    cross_network,
    cross_network_exact,
    cross_network_plain,
    cross_plan,
    exact_gate,
    tolerance_share,
)

RTOL, ATOL = 1e-5, 1e-7
# (5, 520, 2): wider than the fused form's widest D, where the card runs the
# tiled form
CASES = [(37, d, layers) for d in (29, 64) for layers in (0, 1, 3)] + [(5, 520, 2)]


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


def test_cross_module_past_the_fused_width_matches_jax():
    """The port's module at D=520 against the Pallas kernel (interpret mode)
    and the flax module's XLA layer loop. atol 1e-6: an output that cancels
    near zero keeps the absolute error of its 520-term sums, about
    sqrt(520) * 2^-24 * |x0| ~ 3e-7 at x0 ~ N(0, 1)."""
    x0, ws, bs = _inputs(5, 520, 2, seed=10)
    port = CrossNetworkV2(2, 520, device="cpu", generator=torch.Generator().manual_seed(0))
    port.load_state_dict({"ws": torch.from_numpy(ws), "bs": torch.from_numpy(bs)})
    with torch.no_grad():
        got = port(torch.from_numpy(x0)).numpy()
    pallas = np.asarray(cross_network_pallas(jnp.asarray(x0), jnp.asarray(ws), jnp.asarray(bs),
                                             interpret=True))
    module = JaxCrossNetworkV2(num_layers=2, use_pallas=False)
    xla = np.asarray(module.apply({"params": {"ws": jnp.asarray(ws), "bs": jnp.asarray(bs)}},
                                  jnp.asarray(x0)))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("dim", [1, 8, 429, 512, 513, 1677, 4096])
@pytest.mark.parametrize("batch", [1, 5, 1000, 4096, 25600, 32768])
def test_cross_plan_covers_every_shape(batch, dim):
    """Every shape gets a plan; the fused form only up to its widest D; the
    k-slices partition [0, D), each in ascending order."""
    plan = cross_plan(batch, dim)
    assert plan.form in ("fused", "tiled")
    if plan.form == "fused":
        assert dim <= FUSED_MAX_WIDTH and plan.tile is None
    else:
        assert plan.tile in range(len(TILES))
    slices = plan.slices()
    assert 1 <= len(slices) <= MAX_SLICES
    assert all(ks and ks == sorted(ks) for ks in slices)
    assert sorted(k for ks in slices for k in ks) == list(range(dim))


@pytest.mark.parametrize("batch,dim,splits", [
    (1000, 429, 14), (1000, 512, 16), (1000, 37, 3), (200, 1677, 15), (9, 4096, 16),
    (1536, 429, 14), (2000, 429, 1), (4096, 429, 1), (1000, 1677, 15), (4097, 2048, 16),
    (8192, 513, 11), (32768, 513, 1), (32768, 1677, 1), (9601, 1677, 1), (9600, 1677, 15),
])
def test_cross_plan_splits_k_where_the_grid_is_small(batch, dim, splits):
    """k is split where the grid of 64 x 64 output tiles is at most
    SPLIT_MAX_WAVES waves of the SMs, and past FUSED_MAX_WIDTH wherever the
    tile is not 128 x 128, into at most MAX_SLICES contiguous slices of a
    multiple of K_TILE (all but the last)."""
    plan = cross_plan(batch, dim)
    tiles = -(-batch // 64) * -(-dim // 64)
    assert plan.form == "tiled" and plan.splits == splits
    assert (splits > 1) == (tiles <= SPLIT_MAX_WAVES * SM_COUNT
                            or (dim > FUSED_MAX_WIDTH and TILES[plan.tile] != (128, 128)))
    assert all(len(ks) % K_TILE == 0 for ks in plan.slices()[:-1])


def test_cross_plan_takes_the_rows_tile_up_to_eight_rows():
    assert cross_plan(1, 429).tile == ROW_TILE
    assert [cross_plan(b, 1677).tile for b in range(2, 9)] == [0] * 7
    assert cross_plan(9, 429).tile not in (0, ROW_TILE)
    assert cross_plan(5, 4096).splits == 1


def test_plain_version_is_the_layer_loop():
    x0, ws, bs = (torch.from_numpy(a) for a in _inputs(9, 6, 2, seed=3))
    xl = x0
    for layer in range(2):
        xl = cross_layer_v2(x0, xl, ws[layer], bs[layer])
    torch.testing.assert_close(cross_network_plain(x0, ws, bs), xl, rtol=0, atol=0)


@pytest.mark.parametrize("batch,dim,layers", [(9, 6, 2), (37, 520, 3), (4, 1677, 1)])
def test_exact_reference_is_the_float64_layer_loop(batch, dim, layers):
    """``cross_network_exact`` against a numpy loop: float64 products summed
    in float64 and rounded to f32, the update in f32. Tolerance rtol 1e-6 /
    atol 1e-9: the two float64 sums may differ in their last bits, which
    can move an f32 rounding by one ulp."""
    x0, ws, bs = _inputs(batch, dim, layers, seed=dim)
    xl = x0
    for layer in range(layers):
        u = (xl.astype(np.float64) @ ws[layer].astype(np.float64)).astype(np.float32)
        xl = x0 * (u + bs[layer]) + xl
    got = cross_network_exact(*(torch.from_numpy(a) for a in (x0, ws, bs)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), xl, rtol=1e-6, atol=1e-9)


def test_tolerance_share_and_the_exact_gate():
    ref = torch.tensor([0.0, 1.0, -2.0])
    assert tolerance_share(ref, ref) == 0.0
    assert tolerance_share(ref + torch.tensor([1e-6, 0.0, 0.0]), ref) == pytest.approx(1.0)
    # f32 rounds 2 * (1 + 2e-4) to within 1e-7 of it
    assert tolerance_share(ref * (1 + 2e-4), ref) == pytest.approx(4e-4 / (1e-6 + 2e-4), rel=1e-3)
    near = ref + torch.tensor([0.0, 5e-5, 0.0])  # half the tolerance at 1.0
    far = ref + torch.tensor([0.0, 3e-4, 0.0])  # about 3x
    assert exact_gate(near, far, ref)["ok"]  # within the tolerance
    assert exact_gate(far, far, ref)["ok"]  # outside it, but no farther than cuBLAS
    gate = exact_gate(far, near, ref)
    assert not gate["ok"] and gate["kernel"] > 1.0 > gate["cublas"]
    assert not exact_gate(ref + float("nan"), far, ref)["ok"]
    x0, ws, bs = (torch.from_numpy(a) for a in _inputs(37, 520, 3, seed=1))
    assert exact_gate(cross_network_plain(x0, ws, bs), cross_network_plain(x0, ws, bs),
                      cross_network_exact(x0, ws, bs))["ok"]


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
