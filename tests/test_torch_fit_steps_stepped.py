"""The port's packed f32 DCN-v2 step against the JAX trainer's, on the CPU,
each step taken from JAX's state.

``tests/test_torch_fit_steps_fused.py`` runs both trainers freely for 7
steps and holds the Adam-moved values to rtol 1e-4 plus an atol of
N * 1e-4 * lr. This test settles whether that atol hides a fault of the
port: at the same shapes (3 sparse fields of vocab 50, E=8, 2 dense fields,
2 cross layers, MLP (8,), 128-row batches, the packed f32 table under lazy
Adam, lr 1e-2), before each of the 7 steps the port takes JAX's whole state
(the dense parameters, optax's Adam moments and count, the packed
``table || m || v`` rows and the step), as ``chip_smoke.py``'s
``stepped_card_against_cpu`` gives the card the CPU's state. One step then
starts from equal values on both sides, so what it moves must agree to the
north star's rule: every Adam-moved value outside Adam's eps window
(``sqrt(v_hat) < 1e-6``, where the last bits of a gradient that summed to
nearly nothing set the step) rtol 1e-4 / atol 1e-6, those inside it within
one step of lr, the moments rtol 1e-4 with atols that hold the gradient to
1e-7 (``MOMENT_CHECKS`` of ``chip_smoke.py``) and the loss rtol 1e-5.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from test_torch_fit_steps_fused import LR, STEPS, _batches, _pair, _port_model
from pytorchrec_tpu_torch.utils import params_from_jax

E, TABLE = 8, "unified_emb/embedding"
ADAM_B2, EPS_WINDOW = 0.999, 1e-6
RTOL, ATOL = 1e-4, 1e-6
# the moments as multiples of the step's gradient g, as chip_smoke.py's
# MOMENT_CHECKS holds them: m takes (1 - b1) g and sqrt(v) about sqrt(1 - b2) g,
# so atols that hold g to 1e-7 (a tenth of the eps window)
GRAD_ATOL = 1e-7
M_ATOL, SQRT_V_ATOL = 0.1 * GRAD_ATOL, (1 - ADAM_B2) ** 0.5 * GRAD_ATOL


def _leaves(tree):
    flat = traverse_util.flatten_dict(jax.device_get(tree), sep="/")
    return {k: np.asarray(v) for k, v in flat.items() if not isinstance(v, optax.MaskedNode)}


def _jax_state(jax_trainer):
    """(flat params, flat Adam mu, flat Adam nu, Adam count) of the JAX
    trainer's current state."""
    adam = [s for s in jax.tree_util.tree_leaves(
        jax_trainer.state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return (_leaves(jax_trainer.state.params), _leaves(adam[0].mu), _leaves(adam[0].nu),
            int(adam[0].count))


def _port_layout(flat, table):
    """Flax leaves (``flat``, the table's leaf from ``table``) as the port's
    state dict: kernels transposed to ``nn.Linear``'s layout."""
    return params_from_jax({**flat, TABLE: table}, _port_model("f32")).state_dict()


def _load(port, params, mu, nu, count):
    """The port takes JAX's state: its dense parameters, their Adam moments
    and count, the packed table and the step."""
    values = _port_layout(params, params[TABLE])
    exp_avg, exp_avg_sq = (_port_layout(m, params[TABLE]) for m in (mu, nu))
    optimizer = port.state.optimizer
    dense = {id(p) for group in optimizer.param_groups for p in group["params"]}
    with torch.no_grad():
        port.state.packed[TABLE].copy_(torch.from_numpy(params[TABLE].copy()))
        for name, param in port.model.named_parameters():
            if id(param) not in dense:
                continue
            param.copy_(values[name])
            optimizer.state[param] = {"step": torch.tensor(float(count)),
                                      "exp_avg": exp_avg[name].clone(),
                                      "exp_avg_sq": exp_avg_sq[name].clone()}
    port.state.step = count


def _adam_moved(label, got, want, v, step):
    """Values one Adam step moved from a common state; ``v`` JAX's second
    moments after the step."""
    got, want, v = (np.asarray(a, dtype=np.float64) for a in (got, want, v))
    window = np.sqrt(v / (1.0 - ADAM_B2 ** step)) < EPS_WINDOW
    err = np.abs(got - want)
    bad = ~window & (err > RTOL * np.abs(want) + ATOL)
    assert not bad.any(), f"{label}: {int(bad.sum())} values, max abs err {err[bad].max()}"
    assert (err[window] <= 1.01 * LR).all(), f"{label}: a value in the eps window"
    return int(window.sum())


def _moments_close(label, got_m, want_m, got_v, want_v):
    np.testing.assert_allclose(got_m, want_m, rtol=RTOL, atol=M_ATOL, err_msg=label)
    np.testing.assert_allclose(np.sqrt(got_v), np.sqrt(want_v), rtol=RTOL, atol=SQRT_V_ATOL,
                               err_msg=label)


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_each_step_from_jax_state_holds_the_parity_rule(step):
    """Step ``step`` of the 7: JAX steps from its start to just before it;
    the port takes that state, and both take the step on the same batch."""
    batches = _batches()
    jax_trainer, port = _pair("f32", batches)
    for batch in batches[:step - 1]:
        jax_trainer._train_step(batch)
    _load(port, *_jax_state(jax_trainer))
    want_loss = float(jax_trainer._train_step(batches[step - 1]))
    got_loss = float(port.train_step(batches[step - 1]))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    params, mu, nu, count = _jax_state(jax_trainer)
    assert count == step and port.state.step == step
    got_table, want_table = port.state.packed[TABLE].numpy(), params[TABLE]
    _adam_moved("table", got_table[:, :E], want_table[:, :E], want_table[:, 2 * E:3 * E], step)
    _moments_close("table", got_table[:, E:2 * E], want_table[:, E:2 * E],
                   got_table[:, 2 * E:3 * E], want_table[:, 2 * E:3 * E])
    np.testing.assert_array_equal(got_table[:, 3 * E:], want_table[:, 3 * E:])
    values = _port_layout(params, params[TABLE])
    exp_avg, exp_avg_sq = (_port_layout(m, params[TABLE]) for m in (mu, nu))
    moments = port.state.optimizer.state
    checked = 0
    for name, param in port.model.named_parameters():
        if param not in moments:
            continue
        checked += 1
        _adam_moved(name, param.detach().numpy(), values[name].numpy(),
                    exp_avg_sq[name].numpy(), step)
        _moments_close(name, moments[param]["exp_avg"].numpy(), exp_avg[name].numpy(),
                       moments[param]["exp_avg_sq"].numpy(), exp_avg_sq[name].numpy())
    assert checked == 6  # cross ws and bs, the deep layer's weight and bias, the head's
