"""``SolverConfig.remat_policy`` and ``unroll`` of the port against the JAX
package's, on the CPU.

For every supported policy name, on the FC autograd net_u, the fused f32
"torch" path, NAIS-Net, SDENet (JAX's noise, recorded, fed to the port) and
the local objective with Z-matching: the loss
and every gradient within 1e-6 of max|·| of the port's ``remat=False`` (a
policy only decides what the forward pass keeps for the recompute, so it
changes no number), and within 1e-5 of max|·| of JAX's loss under the same
``jax.checkpoint`` policy on the same weights, increments and X0 (f32 on
both sides, other summation orders).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu.solver import SolverConfig as JaxConfig
from dnnpde_tpu.solver import make_loss_fn as jax_make_loss_fn
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn
from dnnpde_tpu_torch.solver.remat import POLICIES

D, M, N = 3, 8, 3
LAYERS = [D + 1, 8, 8, 8, 1]
PORT_TOL = 1e-6  # vs the port's remat=False, of max|.|
JAX_TOL = 1e-5  # vs JAX under the same policy, of max|.|

# name: (net mode, activation, config fields shared by both packages, port fused_net_u)
CASES = {
    "fc": ("FC", "Sine", {}, False),
    "fused": ("FC", "Sine", {"fused_net_u": True}, "torch"),
    "naisnet": ("Naisnet", "Tanh", {}, False),
    "sdenet": ("SDEnet", "Sine", {"stochastic_net": True}, False),
    "local_zmatch": ("FC", "Sine", {"objective": "local", "z_match_weight": 0.5,
                                    "z_match_mask": (0.0, 1.0, 1.0)}, False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _RecordedUniform:
    """``jax.random.uniform`` as it is, recording what it draws for a
    concrete key, in order (``queue``)."""

    def __init__(self):
        self.queue: list[np.ndarray] = []
        self.real = jax.random.uniform

    def __call__(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = self.real(key, shape, dtype, minval, maxval)
        if not isinstance(key, jax.core.Tracer):
            self.queue.append(np.asarray(out))
        return out


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ts = np.broadcast_to(np.linspace(0, 1, N + 1, dtype=np.float32)[:, None, None],
                         (N + 1, M, 1)).copy()
    dWs = (np.sqrt(1.0 / N) * rng.normal(size=(N, M, D))).astype(np.float32)
    X0 = (np.asarray(JaxBSB(D=D).x0) * np.exp(0.1 * rng.normal(size=(M, D)))).astype(np.float32)
    return ts, dWs, X0


def _weights(case):
    mode, act, _, _ = CASES[case]
    net = jax_build_network(mode, LAYERS, act)
    rngs = {"params": jax.random.PRNGKey(1), "sde": jax.random.PRNGKey(9)}
    params = jax.tree.map(np.asarray, net.init(rngs, jnp.ones((1, LAYERS[0]))))
    return net, params


def _as_port_order(case, tree) -> list[np.ndarray]:
    """A JAX parameter (or gradient) tree's leaves in the port's parameter
    order and layout."""
    _, act, _, _ = CASES[case]
    mode = CASES[case][0]
    port = from_flax_params(jax.tree.map(np.asarray, tree), act, mode=mode, device="cpu")
    return [p.detach().numpy() for p in port.parameters()]


def _port(case, policy, remat=True, noise=None):
    mode, act, shared, fused = CASES[case]
    _, params = _weights(case)
    port = from_flax_params(params, act, mode=mode, device="cpu")
    cfg = SolverConfig(remat=remat, remat_policy=policy, **{**shared, "fused_net_u": fused})
    ts, dWs, X0 = (torch.from_numpy(a) for a in _batch())
    kw = {}
    if noise is not None:
        draws = iter(noise)
        kw["noise"] = lambda shape: torch.from_numpy(np.array(next(draws)))
    res = make_loss_fn(BlackScholesBarenblatt(D=D), port, cfg)(port, ts, dWs, X0, **kw)
    grads = torch.autograd.grad(res.loss, list(port.parameters()))
    return float(res.loss.detach()), [g.numpy() for g in grads]


# JAX's alias names are the same policy objects: each is computed once
_JAX_ALIASES = {"checkpoint_dots": "dots_saveable",
                "checkpoint_dots_with_no_batch_dims": "dots_with_no_batch_dims_saveable"}


@functools.lru_cache(maxsize=None)
def _jax_noise(case):
    """SDENet's noise, in the order of the evaluations: drawn from the loss's
    key, which ``jax.checkpoint`` traces, so it is recorded from a run
    without remat and without jit, where every evaluation calls
    ``jax.random.uniform`` on a concrete key (the keys do not depend on
    remat)."""
    net, params = _weights(case)
    shared = CASES[case][2]
    loss_fn = jax_make_loss_fn(JaxBSB(D=D), net, JaxConfig(remat=False, **shared))
    record, real = _RecordedUniform(), jax.random.uniform
    jax.random.uniform = record
    try:
        with jax.disable_jit():
            loss_fn(params, *_batch(), key=jax.random.PRNGKey(3))
    finally:
        jax.random.uniform = real
    assert len(record.queue) == (N + 1) * (len(LAYERS) - 3)
    return record.queue


@functools.lru_cache(maxsize=None)
def _jax(case, policy):
    """JAX's loss and gradients under ``policy`` (and SDENet's noise)."""
    net, params = _weights(case)
    shared = CASES[case][2]
    kw = {"key": jax.random.PRNGKey(3)} if shared.get("stochastic_net") else {}
    loss_fn = jax_make_loss_fn(JaxBSB(D=D), net,
                               JaxConfig(remat=True, remat_policy=policy, **shared))
    batch = _batch()
    loss, g = jax.value_and_grad(lambda p: loss_fn(p, *batch, **kw).loss)(params)
    noise = _jax_noise(case) if shared.get("stochastic_net") else None
    return float(loss), _as_port_order(case, g), noise


def _close(actual, reference, tol):
    actual, reference = np.asarray(actual, np.float64), np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.abs(actual - reference).max() <= tol * (np.abs(reference).max() + 1e-30)


@pytest.mark.parametrize("policy", [None, *POLICIES])
@pytest.mark.parametrize("case", list(CASES))
def test_policy_changes_no_number_and_matches_jax(case, policy):
    loss_j, g_j, noise = _jax(case, _JAX_ALIASES.get(policy, policy))
    loss_p, g_p = _port(case, policy, noise=noise)
    loss_0, g_0 = _port(case, None, remat=False, noise=noise)
    _close(loss_p, loss_0, PORT_TOL)
    for a, r in zip(g_p, g_0):
        _close(a, r, PORT_TOL)
    _close(loss_p, loss_j, JAX_TOL)
    assert len(g_p) == len(g_j)
    for a, r in zip(g_p, g_j):
        _close(a, r, JAX_TOL)


def test_policies_are_jaxs_plain_ones():
    """The six plain names of ``jax.checkpoint_policies``; JAX's factory
    policies (which take arguments) and unknown names raise, and only under
    remat, where JAX reads the field."""
    names = [n for n in dir(jax.checkpoint_policies) if not n.startswith("_")]
    factories = {"offload_dot_with_no_batch_dims", "save_and_offload_only_these_names",
                 "save_any_names_but_these", "save_anything_except_these_names",
                 "save_from_both_policies", "save_only_these_names"}
    assert set(POLICIES) == set(names) - factories
    _, params = _weights("fc")
    port = from_flax_params(params, "Sine", device="cpu")
    prob = BlackScholesBarenblatt(D=D)
    for bad in sorted(factories) + ["no_such_policy"]:
        with pytest.raises(ValueError, match="supported"):
            make_loss_fn(prob, port, SolverConfig(remat_policy=bad))
        make_loss_fn(prob, port, SolverConfig(remat=False, remat_policy=bad))


def test_unroll_changes_no_number():
    """``unroll`` is lax.scan's factor: accepted as an int >= 1 or a bool,
    bitwise the same loss and gradients; anything else raises."""
    _, params = _weights("fc")
    prob = BlackScholesBarenblatt(D=D)
    ts, dWs, X0 = (torch.from_numpy(a) for a in _batch())
    out = []
    for unroll in (1, 2, 4, True, False):
        port = from_flax_params(params, "Sine", device="cpu")
        res = make_loss_fn(prob, port, SolverConfig(unroll=unroll))(port, ts, dWs, X0)
        out.append([res.loss.detach(), *torch.autograd.grad(res.loss, list(port.parameters()))])
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], other))
    port = from_flax_params(params, "Sine", device="cpu")
    for bad in (0, -2, 1.5, "4"):
        with pytest.raises(ValueError, match="unroll"):
            make_loss_fn(prob, port, SolverConfig(unroll=bad))


def test_trainer_under_a_policy_trains_as_without_remat():
    """Three Trainer iterations under "dots_saveable" and without remat,
    from the same seed: the same losses, Y0s and weights, bit for bit."""
    from dnnpde_tpu_torch.train import Trainer

    out = []
    for cfg in (SolverConfig(remat=False), SolverConfig(remat=True, remat_policy="dots_saveable")):
        tr = Trainer(BlackScholesBarenblatt(D=D), M=M, N=N, layers=LAYERS, seed=0,
                     solver_config=cfg, device="cpu")
        res = tr.train(3, 1e-3, log_every=1, verbose=False)
        out.append((res.graph, res.y0_history, [p.detach().clone() for p in tr._params]))
    (ga, ya, pa), (gb, yb, pb) = out
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(ya, yb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
