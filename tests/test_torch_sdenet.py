"""The port's SDENet and the stochastic-net threading against the JAX package.

Weights come from a flax init carried across with ``from_flax_params``. With
the noise off (``deterministic=True``), u within 1e-6 of max|u|. With noise,
the two generators differ (threefry against PyTorch's), so the same noise is
injected on both sides: ``jax.random.uniform`` is replaced by a function that
hands out numpy draws, one per new key (a key seen before gets its earlier
draw, as a threefry key would), and the port's draws are fed the same arrays
in the same order; u within 1e-5 of max|u|, the first three training losses
and Y0s within 1e-5 relative. Without injection, the mean of u over 4096
draws within 4 combined standard errors of JAX's. The evaluation paths
(``predict``, ``evaluate_u``, greeks, serving) repeat exactly from call to
call, and the greeks' rows equal batch-of-one evaluations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu.sim.brownian import brownian_increments as jax_increments
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch.evals import StabilityCheck, compute_greeks
from dnnpde_tpu_torch.nets import SDENet, build_network
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.serve import load_solution, save_solution
from dnnpde_tpu_torch.train import Trainer

LAYERS = [4, 16, 16, 16, 1]
B = 12


def _close(actual, reference, tol):
    actual, reference = np.asarray(actual, np.float64), np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.abs(actual - reference).max() <= tol * (np.abs(reference).max() + 1e-30)


class _InjectedUniform:
    """``jax.random.uniform`` replaced by numpy U[0, 1) draws: one per
    concrete key not seen before, in order (``queue``); a key seen before
    gets its earlier draw. Traced keys (flax's shape checks of initializers)
    go to the real function."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.cache: dict[bytes, np.ndarray] = {}
        self.queue: list[np.ndarray] = []
        self.real = jax.random.uniform

    def __call__(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if isinstance(key, jax.core.Tracer):
            return self.real(key, shape, dtype, minval, maxval)
        k = np.asarray(key).tobytes()
        if k not in self.cache:
            self.cache[k] = self.rng.uniform(size=shape).astype(np.float32)
            self.queue.append(self.cache[k])
        return jnp.asarray(self.cache[k])


def _pair(act="sine", deterministic=False, seed=1):
    net = jax_build_network("SDEnet", LAYERS, act, deterministic=deterministic)
    params = net.init({"params": jax.random.PRNGKey(seed), "sde": jax.random.PRNGKey(9)},
                      jnp.ones((1, LAYERS[0])))
    port = from_flax_params(jax.tree.map(np.asarray, params), act, device="cpu",
                            deterministic=deterministic)
    return net, params, port


def _x(seed=3, batch=B):
    return np.random.default_rng(seed).normal(size=(batch, LAYERS[0])).astype(np.float32)


def _port_noise(queue):
    draws = iter(queue)
    return lambda shape: torch.from_numpy(next(draws))


@pytest.mark.parametrize("act", ["sine", "relu"])
def test_deterministic_sdenet_matches_flax(act):
    """Noise off (0.5 in its place): the same weights give u within 1e-6."""
    net, params, port = _pair(act, deterministic=True)
    assert isinstance(port, SDENet) and len(port.brownian) == len(LAYERS) - 3
    x = _x()
    _close(port(torch.from_numpy(x)).detach().numpy(), np.asarray(net.apply(params, x)), 1e-6)


def test_injected_noise_matches_flax(monkeypatch):
    """Noise on, the same draws on both sides: u within 1e-5 of max|u|."""
    net, params, port = _pair()
    x = _x()
    fake = _InjectedUniform(0)
    monkeypatch.setattr(jax.random, "uniform", fake)
    ref = np.asarray(net.apply(params, x, rngs={"sde": jax.random.PRNGKey(4)}))
    assert [q.shape for q in fake.queue] == port.noise_shapes(B)
    noise = port.draw_noise(_port_noise(fake.queue), B)
    _close(port(torch.from_numpy(x), noise).detach().numpy(), ref, 1e-5)


def test_mean_over_noise_matches_flax_statistically():
    """4096 independent draws at one state: the means of u agree within 4
    combined standard errors (the generators differ, the law does not)."""
    net, params, port = _pair()
    n = 4096
    x = np.repeat(_x(batch=1), n, axis=0)
    uj = np.asarray(net.apply(params, x, rngs={"sde": jax.random.PRNGKey(5)}))[:, 0]
    gen = torch.Generator().manual_seed(5)
    noise = port.draw_noise(lambda shape: torch.rand(shape, generator=gen), n)
    up = port(torch.from_numpy(x), noise).detach().numpy()[:, 0]
    se = np.sqrt(uj.var() / n + up.var() / n)
    assert uj.std() > 1e-4 and up.std() > 1e-4  # the noise moves u
    assert abs(uj.mean() - up.mean()) < 4 * se


def _jax_draws(jtr, n_iter):
    """The increments (time-major) JAX's ``train(n_iter, log_every=1)``
    draws from ``jtr``'s key, in order."""
    key, out, p = jtr.key, [], jtr.problem
    for _ in range(n_iter):
        key, sub = jax.random.split(key)
        (kk,) = jax.random.split(sub, 1)
        dW = jax_increments(jax.random.split(kk, 3)[0], jtr.M, jtr.N, p.noise_dim,
                            p.T / jtr.N, jtr.chol, jtr.dtype)
        out.append(np.swapaxes(np.asarray(dW), 0, 1).copy())
    return out


@pytest.mark.parametrize("objective", ["global", "local_ema"])
def test_three_trainer_iterations_match_jax_on_its_draws(objective, monkeypatch):
    """``Trainer(mode="SDEnet")`` on JAX's weights, increments and injected
    noise: the first three losses and Y0s within 1e-5 relative. JAX runs
    without jit, so that every net evaluation calls ``jax.random.uniform``;
    under local_ema the target's evaluation reuses its step's key, and the
    port's its step's noise."""
    kw = dict(M=8, N=4, layers=LAYERS, mode="SDEnet", seed=0, ema_decay=0.9,
              objective=objective)
    jtr = JaxTrainer(JaxBSB(D=3), **kw)
    tr = Trainer(BlackScholesBarenblatt(D=3), device="cpu", **kw)
    assert tr.config.stochastic_net and jtr.config.stochastic_net
    src = from_flax_params(jax.tree.map(np.asarray, jtr.params), "sine", device="cpu")
    with torch.no_grad():
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    draws = iter(_jax_draws(jtr, 3))
    fake = _InjectedUniform(7)
    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(jax.random, "uniform", fake)
        rj = jtr.train(3, 1e-3, log_every=1, verbose=False)
    # 3 iterations x (N + 1) evaluations x 2 blocks, the targets' included
    assert len(fake.queue) == 3 * 5 * 2
    tr._increments = lambda n: torch.from_numpy(next(draws))
    tr._noise = _port_noise(fake.queue)
    rp = tr.train(3, 1e-3, log_every=1, verbose=False)
    for i in range(3):
        _close(rp.graph[1][i], rj.graph[1][i], 1e-5)
        _close(rp.y0_history[i], rj.y0_history[i], 1e-5)


def test_sdenet_stochastic_and_deterministic():
    """tests/test_nets.py's SDENet test: two noise draws differ; the
    deterministic net repeats; the evaluation default repeats too."""
    x = torch.ones((4, LAYERS[0]))
    net = build_network("SDEnet", LAYERS, "relu", generator=torch.Generator().manual_seed(0),
                        device="cpu")
    y1, y2 = (net(x, net.draw_noise(lambda s, g=torch.Generator().manual_seed(k):
                                    torch.rand(s, generator=g), 4)) for k in (2, 3))
    assert not torch.allclose(y1, y2)
    assert torch.equal(net(x), net(x))
    det = build_network("SDEnet", LAYERS, "relu", deterministic=True, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(det(x), det(x))


def test_sdenet_training_runs_and_draws_from_the_trainer_generator():
    """tests/test_train.py's SDENet test, and the noise's source: each
    iteration advances the trainer's generator by the noise too."""
    kw = dict(M=8, N=4, layers=[4, 16, 16, 16, 16, 1], seed=0, device="cpu")
    tr = Trainer(BlackScholesBarenblatt(D=3), mode="SDEnet", **kw)
    assert tr.config.stochastic_net
    res = tr.train(6, 1e-3, log_every=3, verbose=False)
    assert np.isfinite(res.graph[1]).all()
    fc = Trainer(BlackScholesBarenblatt(D=3), **kw)
    fc.train(6, 1e-3, log_every=3, verbose=False)
    assert not torch.equal(tr.generator.get_state(), fc.generator.get_state())


def test_eval_paths_and_serving_are_deterministic(tmp_path):
    """predict, evaluate_u and the served (u, Z) repeat exactly and leave the
    trainer's generator alone; the served (u, Z) equal the eval path's
    (tests/test_serve.py's SDENet export test)."""
    prob = BlackScholesBarenblatt(D=3)
    tr = Trainer(prob, M=4, N=2, layers=[4, 8, 8, 1], mode="SDEnet", seed=0, device="cpu")
    tr.train(4, 1e-3, log_every=2, verbose=False)
    state = tr.generator.get_state()
    t, W = tr.fetch_minibatch(generator=torch.Generator().manual_seed(1))
    p1, p2 = (tr.predict(prob.x0.numpy(), t, W)[1] for _ in range(2))
    np.testing.assert_array_equal(p1, p2)
    X = np.random.default_rng(2).uniform(0.5, 1.5, (5, 3)).astype(np.float32)
    tz = np.zeros((5, 1), np.float32)
    (u1, z1), (u2, z2) = tr.evaluate_u(tz, X), tr.evaluate_u(tz, X)
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(z1, z2)
    assert torch.equal(state, tr.generator.get_state())
    save_solution(str(tmp_path / "sde.pt"), tr)
    sol = load_solution(str(tmp_path / "sde.pt"), device="cpu")
    assert sol.record["mode"] == "SDEnet"
    us, zs = sol.u_and_grad(tz, X)
    _close(us, u1, 1e-5)
    _close(zs, z1, 1e-5)
    np.testing.assert_array_equal(us, sol.u_and_grad(tz, X)[0])


def test_greeks_rows_equal_batch_of_one_evaluations():
    """JAX evaluates each greeks sample (and each point of StabilityCheck's
    Jacobian surface) as a batch of one under the fixed key, so every row
    sees the same noise row: each row's (u, delta) equal evaluate_u on that
    sample alone."""
    tr = Trainer(BlackScholesBarenblatt(D=3), M=4, N=2, layers=[4, 8, 8, 8, 1],
                 mode="SDEnet", seed=3, device="cpu")
    X = np.random.default_rng(4).uniform(0.5, 1.5, (6, 3)).astype(np.float32)
    t = np.linspace(0.0, 0.9, 6, dtype=np.float32)[:, None]
    u, delta, gamma = compute_greeks(tr, t, X)
    assert np.isfinite(gamma).all()
    for i in range(6):
        ui, zi = tr.evaluate_u(t[i:i + 1], X[i:i + 1])
        _close(u[i], ui[0], 1e-6)
        _close(delta[i], zi[0], 1e-5)
    # StabilityCheck's Jacobian surface evaluates its points as JAX does, each
    # as a batch of one
    t_grid, s_grid = np.asarray([0.0, 0.5]), np.asarray([0.8, 1.2])
    surface = StabilityCheck(tr).jacobian_surface(t_grid, s_grid)
    x0 = tr.problem.x0.numpy()
    for i, ti in enumerate(t_grid):
        for j, sj in enumerate(s_grid):
            x = x0.copy()
            x[0] = sj
            _, zi = tr.evaluate_u([[ti]], x[None])
            _close(surface[i, j], np.linalg.norm(zi), 1e-5)


def test_lbfgs_and_polish_draw_one_noise_per_batch():
    """LBFGS's linesearch and ``polish`` evaluate one batch many times under
    one noise draw, as JAX passes one key to every evaluation of the batch:
    the trainer's generator supplies one evaluation pass of noise per LBFGS
    iteration and per polish, however many evaluations the linesearch makes."""
    tr = Trainer(BlackScholesBarenblatt(D=3), M=8, N=4, layers=LAYERS, mode="SDEnet", seed=0,
                 device="cpu")
    shapes = []
    draw = tr._noise
    tr._noise = lambda shape: shapes.append(shape) or draw(shape)
    res = tr.train(2, 1.0, "LBFGS", log_every=1, verbose=False)
    per_pass = (tr.N + 1) * (len(LAYERS) - 3)
    assert np.isfinite(res.graph[1]).all() and len(shapes) == 2 * per_pass
    shapes.clear()
    losses = tr.polish(4, M=16)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert len(shapes) == 0  # polish draws from the trainer's generator directly
    gen_state = tr.generator.get_state()
    tr.polish(2, M=16, seed=3)
    assert torch.equal(gen_state, tr.generator.get_state())  # a seeded polish leaves it alone
