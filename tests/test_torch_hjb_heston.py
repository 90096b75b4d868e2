"""The port's HJB and Heston problems against the JAX package's, on the CPU:
every problem method on the same numpy inputs (within 1e-6 of max(1,
max|ref|)), one global loss and its parameter gradients on the same
increments against the JAX solver (within 1e-5 of max|ref| per tensor, f32
on both sides in other summation orders), and a 3-iteration Trainer run fed
the increments the JAX Trainer draws (each value within 1e-5 of max|ref| per
optimizer step taken before it, as ``test_torch_trainer_state.py`` holds
trajectories)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.pde import HamiltonJacobiBellman as JaxHJB
from dnnpde_tpu.pde import HestonPDE as JaxHeston
from dnnpde_tpu.sim.brownian import brownian_increments as jax_increments
from dnnpde_tpu.solver import SolverConfig as JaxConfig
from dnnpde_tpu.solver import make_loss_fn as jax_make_loss_fn
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import HamiltonJacobiBellman, HestonPDE
from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn
from dnnpde_tpu_torch.train import Trainer

B = 24
HESTON_CASES = {
    "bs-tanh": {},
    "bs-erf": {"bs_cdf": "erf"},
    "hard": {"clamp_smoothing": "hard"},
    "softplus": {"clamp_smoothing": "softplus"},
    "anchor": {"clamp_smoothing": "anchor"},
    "anchor-unscaled": {"clamp_smoothing": "anchor", "anchor_time_scale": "none"},
    "plain": {"clamp_output": False},
    "reference-diffusion": {"diffusion": "reference"},
    "continuous-payoff": {"payoff_type": "continuous", "clamp_smoothing": "hard"},
}


def _close(actual, reference, tol):
    actual = np.asarray(actual, np.float64)
    reference = np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.abs(actual - reference).max() <= tol * (np.abs(reference).max() + 1e-30)


def _inputs(dim, heston, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.0, size=(B, 1)).astype(np.float32)
    t[:4] = 1.0  # τ = 0: the heads' terminal values
    if heston:
        S = rng.uniform(0.5, 1.5, size=(B, 1))
        v = rng.uniform(-0.05, 0.4, size=(B, 1))  # below 0 too: the √v clip
        X = np.concatenate([S, v], axis=1).astype(np.float32)
    else:
        X = rng.normal(size=(B, dim)).astype(np.float32)
    Y = rng.normal(size=(B, 1)).astype(np.float32)
    Z = rng.normal(size=(B, dim)).astype(np.float32)
    raw = (0.3 * rng.normal(size=(B, 1))).astype(np.float32)
    return t, X, Y, Z, raw


def _problems():
    out = [("hjb", JaxHJB(D=10), HamiltonJacobiBellman(D=10))]
    out += [(f"heston-{k}", JaxHeston(**kw), HestonPDE(**kw)) for k, kw in HESTON_CASES.items()]
    return out


@pytest.mark.parametrize("name,jprob,prob", _problems(), ids=[p[0] for p in _problems()])
def test_problem_methods_match_jax(name, jprob, prob):
    assert dataclasses.asdict(prob) == dataclasses.asdict(jprob)
    assert (prob.dim, prob.noise_dim, prob.sigma_kind) == (jprob.dim, jprob.noise_dim,
                                                           jprob.sigma_kind)
    assert prob.clamp_u == jprob.clamp_u
    assert prob.has_output_transform == jprob.has_output_transform
    np.testing.assert_array_equal(prob.x0.numpy(), np.asarray(jprob.x0))
    jmask = jprob.z_penalty_mask
    assert (prob.z_penalty_mask is None) == (jmask is None)
    if jmask is not None:
        np.testing.assert_array_equal(prob.z_penalty_mask.numpy(), np.asarray(jmask))

    t, X, Y, Z, raw = _inputs(prob.dim, name.startswith("heston"))
    tt, Xt, Yt, Zt, rt = (torch.from_numpy(a) for a in (t, X, Y, Z, raw))
    pairs = {
        "mu": (prob.mu(tt, Xt, Yt, Zt), jprob.mu(t, X, Y, Z)),
        "sigma": (prob.sigma(tt, Xt, Yt), jprob.sigma(t, X, Y)),
        "phi": (prob.phi(tt, Xt, Yt, Zt), jprob.phi(t, X, Y, Z)),
        "g": (prob.g(Xt), jprob.g(X)),
        "Dg": (prob.Dg(Xt), jprob.Dg(jnp.asarray(X))),
        "transform_u": (prob.transform_u(tt, Xt, rt), jprob.transform_u(t, X, raw)),
    }
    if name.startswith("heston"):
        pairs["intrinsic_floor"] = (prob.intrinsic_floor(tt, Xt), jprob.intrinsic_floor(t, X))
    for key, (ours, ref) in pairs.items():
        ref = np.asarray(ref)
        assert np.isfinite(ours.numpy()).all(), key
        assert ours.shape == ref.shape, key
        assert np.abs(ours.numpy() - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max()), key


def test_heston_terminal_z_is_finite_and_exact_under_the_bs_head():
    """At τ = 0 the "bs" head is the payoff and Z is its gradient (1{S>K},
    0), with finite parameter gradients of a loss on Z even where v is
    clipped."""
    from dnnpde_tpu_torch.nets import MLP
    from dnnpde_tpu_torch.solver import make_net_u

    prob = HestonPDE()
    net = MLP([3, 16, 16, 1], "sine", generator=torch.Generator().manual_seed(0), device="cpu")
    S = torch.tensor([0.5, 0.9, 1.1, 2.0, 1e-6])
    X = torch.stack([S, torch.tensor([0.2, -0.1, 1e-12, 0.3, 0.2])], dim=-1)
    u, Z = make_net_u(net, prob.transform_u)(torch.ones(5, 1), X)
    np.testing.assert_allclose(u[:, 0].detach().numpy(), np.maximum(S.numpy() - 1.0, 0.0))
    np.testing.assert_array_equal(Z.detach().numpy(), np.stack(
        [(S.numpy() > 1.0).astype(np.float32), np.zeros(5, np.float32)], axis=-1))
    grads = torch.autograd.grad((Z**2).sum() + (u**2).sum(), list(net.parameters()),
                                allow_unused=True)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)


LOSS_CASES = {
    "hjb-naisnet-relu": (JaxHJB(D=10), HamiltonJacobiBellman(D=10), "Naisnet", "ReLU"),
    "heston-bs": (JaxHeston(), HestonPDE(), "FC", "Sine"),
    "heston-hard": (JaxHeston(clamp_smoothing="hard"), HestonPDE(clamp_smoothing="hard"),
                    "FC", "Sine"),
}


def _net_pair(prob, mode, act, width=16, seed=2):
    layers = [prob.dim + 1, width, width, width, 1]
    net = jax_build_network(mode, layers, act)
    params = net.init(jax.random.PRNGKey(seed), jnp.ones((1, layers[0])))
    port = from_flax_params(jax.tree.map(np.asarray, params), act, mode=mode, device="cpu")
    return layers, net, params, port


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_gradients_match_the_jax_solver(case):
    jprob, prob, mode, act = LOSS_CASES[case]
    layers, net, params, port = _net_pair(prob, mode, act)
    M, N = 16, 6
    rng = np.random.default_rng(11)
    ts = np.broadcast_to(np.linspace(0.0, 1.0, N + 1, dtype=np.float32)[:, None, None],
                         (N + 1, M, 1)).copy()
    dWs = (np.sqrt(1.0 / N) * rng.normal(size=(N, M, prob.dim))).astype(np.float32)
    X0 = np.broadcast_to(np.asarray(jprob.x0), (M, prob.dim)).copy()
    if case.startswith("hjb"):
        X0 = X0 + 0.3 * rng.normal(size=X0.shape).astype(np.float32)

    jloss = jax_make_loss_fn(jprob, net, JaxConfig(remat=False))
    (ref_loss, ref_y0), ref_grads = jax.value_and_grad(
        lambda p: (lambda r: (r.loss, r.Y0))(jloss(p, ts, dWs, X0)), has_aux=True)(params)
    for remat in (False, True):
        loss_fn = make_loss_fn(prob, port, SolverConfig(remat=remat))
        res = loss_fn(port, *(torch.from_numpy(a) for a in (ts, dWs, X0)))
        grads = torch.autograd.grad(res.loss, list(port.parameters()))
        loss = float(res.loss.detach())
        assert np.isfinite(loss)
        _close(loss, float(ref_loss), 1e-5)
        _close(float(res.Y0.detach()), float(ref_y0), 1e-5)
        # the JAX gradient tree read as a port net lines its tensors up with ours
        ref = from_flax_params(jax.tree.map(np.asarray, ref_grads), act, mode=mode, device="cpu")
        for g, r in zip(grads, ref.parameters()):
            _close(g.numpy(), r.detach().numpy(), 1e-5)


def _jax_draws(jtr, n_iter, log_every):
    """The increments (time-major) the JAX ``train(n_iter, log_every=...)``
    draws from ``jtr``'s current key, in order."""
    key, out, done = jtr.key, [], 0
    p = jtr.problem
    while done < n_iter:
        k = min(log_every, n_iter - done)
        key, sub = jax.random.split(key)
        for kk in jax.random.split(sub, k):
            dW = jax_increments(jax.random.split(kk, 3)[0], jtr.M, jtr.N, p.noise_dim,
                                p.T / jtr.N, jtr.chol, jtr.dtype)
            out.append(np.swapaxes(np.asarray(dW), 0, 1).copy())
        done += k
    return out


@pytest.mark.parametrize("case", ["hjb-naisnet-relu", "heston-bs"])
def test_three_trainer_iterations_match_jax_on_its_increments(case):
    jprob, prob, mode, act = LOSS_CASES[case]
    layers = [prob.dim + 1, 16, 16, 16, 1]
    jtr = JaxTrainer(jprob, M=8, N=4, layers=layers, mode=mode, activation=act, seed=0,
                     ema_decay=0.9)
    tr = Trainer(prob, M=8, N=4, layers=layers, mode=mode, activation=act, seed=0,
                 ema_decay=0.9, device="cpu")
    src = from_flax_params(jax.tree.map(np.asarray, jtr.params), act, mode=mode, device="cpu")
    with torch.no_grad():
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    draws = iter(_jax_draws(jtr, 3, 1))
    tr._increments = lambda n: torch.from_numpy(next(draws))
    rj = jtr.train(3, 1e-3, log_every=1, verbose=False)
    rp = tr.train(3, 1e-3, log_every=1, verbose=False)
    for i in range(3):
        _close(rp.graph[1][i], rj.graph[1][i], 1e-5 * max(i, 1))
        _close(rp.y0_history[i], rj.y0_history[i], 1e-5 * max(i, 1))
    for ours, ref in ((tr.params, jtr.params), (tr.ema_params, jtr.ema_params)):
        ref_net = from_flax_params(jax.tree.map(np.asarray, ref), act, mode=mode, device="cpu")
        for a, r in zip(ours.parameters(), ref_net.parameters()):
            _close(a.detach().numpy(), r.detach().numpy(), 3e-5)


def test_heston_hard_clamp_collapse_restarts_and_bs_head_does_not():
    """The "hard" clamp's u ≡ 0 is an absorbing state that the collapse
    check catches (clamp_u = 0); the "bs" head has no clamp to pin at."""
    kw = dict(M=8, N=4, layers=[3, 16, 16, 1], device="cpu", collapse_restart=True,
              collapse_max_restarts=2)
    hard = Trainer(HestonPDE(clamp_smoothing="hard"), **kw)
    with torch.no_grad():  # raw u far below 0 everywhere: Y0 pinned at the clamp
        hard.params.dense[-1].linear.bias.sub_(1e3)
    hard.train(4, 1e-3, log_every=2, verbose=False)
    assert hard.collapse_restarts == [0, 0] and hard.y0_log == [0.0, 0.0]
    bs = Trainer(HestonPDE(), **kw)
    assert bs.problem.clamp_u is None and not bs._collapsed_y0(0.0)
    bs.train(4, 1e-3, log_every=2, verbose=False)
    assert bs.collapse_restarts == [] and np.isfinite(bs.y0_log).all()
