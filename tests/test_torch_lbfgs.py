"""The port's LBFGS against ``optax.lbfgs``, on the CPU: from the same start
it follows optax's losses for 10 steps within 1e-4 relative on the
Rosenbrock function and on a frozen-batch polish of CallOption1D on a
[2, 8, 8, 1] net fed JAX's batch; three LBFGS training iterations on JAX's
increments match JAX's; ``polish``'s bookkeeping is JAX's; and a 300-step
polish of a warm-started 1-D call cuts its loss at least 2x."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnnpde_tpu.pde import CallOption1D as JaxCall
from dnnpde_tpu.sim.brownian import brownian_increments as jax_increments
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import CallOption1D
from dnnpde_tpu_torch.sim import time_grid
from dnnpde_tpu_torch.train import Trainer, build_optimizer
from dnnpde_tpu_torch.train.optimizers import LBFGS


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _rosen(x, lib):
    return lib.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


@pytest.mark.parametrize("lr", [None, 0.5])
def test_rosenbrock_follows_optax(lr):
    x0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.3], np.float32)
    opt = optax.lbfgs(lr)
    p = jnp.asarray(x0)
    st = opt.init(p)
    ref = []
    f = lambda x: _rosen(x, jnp)
    for _ in range(10):
        v, g = jax.value_and_grad(f)(p)
        u, st = opt.update(g, st, p, value=v, grad=g, value_fn=f)
        p = optax.apply_updates(p, u)
        ref.append(float(v))

    def value_and_grad(trial):
        with torch.enable_grad():
            x = trial[0].detach().requires_grad_(True)
            v = _rosen(x, torch)
            (g,) = torch.autograd.grad(v, x)
        return v.detach(), [g]

    tx = build_optimizer("LBFGS", lr)
    assert isinstance(tx, LBFGS)
    q = torch.tensor(x0)
    state = tx.init([q])
    ours = []
    for _ in range(10):
        v, g = value_and_grad([q])
        u, state = tx.update(g, state, [q], value=v, value_and_grad=value_and_grad)
        q = q + u[0]
        ours.append(float(v))
    assert int(state["count"]) == 10
    assert _rel(ours, ref).max() <= 1e-4
    assert ours[-1] < 0.5 * ours[0]


def _pair(seed=0, **kw):
    """A JAX trainer and a port trainer holding its weights: the 1-D call on
    a [2, 8, 8, 1] FC-Sine net."""
    kw = dict(M=16, N=5, layers=[2, 8, 8, 1], seed=seed, **kw)
    jtr = JaxTrainer(JaxCall(), **kw)
    tr = Trainer(CallOption1D(), **kw, device="cpu")
    src = from_flax_params(jax.tree.map(np.asarray, jtr.params), "Sine", device="cpu")
    with torch.no_grad():
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    return jtr, tr


def _jax_polish_batch(jtr, M, seed):
    """The frozen antithetic batch ``jtr.polish(M=M, seed=seed)`` draws."""
    p = jtr.problem
    kw, _, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    dW = jax_increments(kw, M, jtr.N, p.noise_dim, p.T / jtr.N, jtr.chol, jtr.dtype,
                        antithetic=True)
    dWs = torch.from_numpy(np.swapaxes(np.asarray(dW), 0, 1).copy())
    ts = time_grid(M, jtr.N, p.T, device="cpu").transpose(0, 1)
    X0 = CallOption1D().x0.expand(M, 1)
    return ts, dWs, X0


def test_frozen_batch_polish_follows_jax_and_keeps_its_books():
    jtr, tr = _pair(ema_decay=0.9)
    jtr.train(2, 1e-3, log_every=1, verbose=False)
    tr.train(2, 1e-3, log_every=1, verbose=False)
    with torch.no_grad():  # the same start: JAX's weights after its two steps
        src = from_flax_params(jax.tree.map(np.asarray, jtr.params), "Sine", device="cpu")
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    ema_before = [e.clone() for e in tr.ema_params.parameters()]
    ref = jtr.polish(n_iter=10, M=256, seed=7)
    ours = tr._polish_on(*_jax_polish_batch(jtr, 256, 7), n_iter=10)
    assert ours.shape == ref.shape == (10,)
    assert _rel(ours, ref).max() <= 1e-4, (ours, ref)
    assert ours[-1] < ours[0]
    assert tr.iteration == jtr.iteration == [0, 1, 2]
    assert tr._next_it == jtr._next_it == 12
    assert len(tr.training_loss) == len(jtr.training_loss) == 3
    assert tr.training_loss[-1] == pytest.approx(float(ours[-1]))
    assert tr.y0_log[-1] == pytest.approx(jtr.y0_log[-1], rel=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(tr.ema_params.parameters(), ema_before))


def test_polish_draws_its_frozen_batch_and_rounds_m_up():
    _, tr = _pair()
    state = tr.generator.get_state()
    losses = tr.polish(n_iter=3, M=33, seed=5)
    assert losses.shape == (3,) and np.isfinite(losses).all()
    assert torch.equal(tr.generator.get_state(), state)  # a seed draws from its own stream
    tr.polish(n_iter=2, M=33)
    assert not torch.equal(tr.generator.get_state(), state)
    assert tr.iteration == [0, 3] and tr._next_it == 5


def test_polish_restores_the_callers_matmul_settings():
    _, tr = _pair()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        tr.polish(n_iter=1, M=8, seed=0)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def _jax_draws(jtr, n_iter):
    """The increments (time-major) ``jtr.train(n_iter, log_every=1)`` draws."""
    key, out = jtr.key, []
    p = jtr.problem
    for _ in range(n_iter):
        key, sub = jax.random.split(key)
        (kk,) = jax.random.split(sub, 1)
        dW = jax_increments(jax.random.split(kk, 3)[0], jtr.M, jtr.N, p.noise_dim,
                            p.T / jtr.N, jtr.chol, jtr.dtype)
        out.append(np.swapaxes(np.asarray(dW), 0, 1).copy())
    return out


def test_three_lbfgs_training_iterations_match_jax_on_its_increments():
    """train(…, "LBFGS"): each iteration's linesearch re-evaluates the loss
    on that iteration's batch (eagerly), as JAX's chunk does."""
    jtr, tr = _pair(seed=1)
    draws = iter(_jax_draws(jtr, 3))
    tr._increments = lambda n: torch.from_numpy(next(draws))
    rj = jtr.train(3, 1e-2, "LBFGS", log_every=1, verbose=False)
    rp = tr.train(3, 1e-2, "LBFGS", log_every=1, verbose=False)
    assert _rel(rp.graph[1], rj.graph[1]).max() <= 1e-4
    assert _rel(rp.y0_history, rj.y0_history).max() <= 1e-4
    assert tr._chunk_cache and all(c.graph is None for c in tr._chunk_cache.values())


@pytest.fixture
def one_thread():
    """One intra-op thread: the polish is hundreds of small eager ops, which
    many threads per worker slow down far more than they speed up."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_polish_of_a_warm_started_call_cuts_its_loss_2x(one_thread):
    tr = Trainer(CallOption1D(), M=128, N=5, layers=[2, 32, 32, 1], seed=0, device="cpu")
    tr.train(300, 1e-3, log_every=100, verbose=False)
    losses = tr.polish(n_iter=300, M=512, seed=0)
    assert np.isfinite(losses).all()
    assert losses[-1] <= 0.5 * losses[0], (losses[0], losses[-1])
