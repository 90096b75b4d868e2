"""The port's path-dependent problems (up-and-out barrier, Asian and
lookback calls) against the JAX package's, on the CPU: every problem
method on the same seeded states (within 1e-6 of max(1, max|ref|)), both
barrier monitors, and three Trainer iterations under the local and the
global objective on JAX's weights and increments (losses and Y0 within
1e-5 of max|ref| per optimizer step taken before them, as
``test_torch_hjb_heston.py`` holds trajectories)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.pde import AsianCallOption as JaxAsian
from dnnpde_tpu.pde import LookbackCallOption as JaxLookback
from dnnpde_tpu.pde import UpAndOutCall as JaxBarrier
from dnnpde_tpu.sim.brownian import brownian_increments as jax_increments
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import AsianCallOption, LookbackCallOption, UpAndOutCall
from dnnpde_tpu_torch.train import Trainer

B = 32
N_TRAIN = 4
CASES = {
    "barrier-smooth": (JaxBarrier(), UpAndOutCall()),
    "barrier-hard": (JaxBarrier(smooth_beta=None), UpAndOutCall(smooth_beta=None)),
    "asian": (JaxAsian(N_samples=N_TRAIN), AsianCallOption(N_samples=N_TRAIN)),
    "lookback": (JaxLookback(), LookbackCallOption()),
}


def _close(actual, reference, tol):
    actual = np.asarray(actual, np.float64)
    reference = np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.abs(actual - reference).max() <= tol * max(1.0, np.abs(reference).max())


def _states(seed=0):
    """Seeded states around the contracts: S across the barrier at 1.3, the
    path statistic (alive factor, running average or minimum) in [0, 1.2]."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.0, size=(B, 1)).astype(np.float32)
    S = rng.uniform(0.6, 1.6, size=(B, 1))
    S[:3, 0] = [1.3, 1.3 - 1e-3, 1.3 + 1e-3]  # at and beside the barrier
    stat = rng.uniform(0.0, 1.2, size=(B, 1))
    X = np.concatenate([S, stat], axis=1).astype(np.float32)
    Y = rng.normal(size=(B, 1)).astype(np.float32)
    Z = rng.normal(size=(B, 2)).astype(np.float32)
    raw = rng.normal(size=(B, 1)).astype(np.float32)
    return t, X, Y, Z, raw


@pytest.mark.parametrize("case", list(CASES))
def test_problem_methods_match_jax(case):
    jprob, prob = CASES[case]
    assert dataclasses.asdict(prob) == dataclasses.asdict(jprob)
    assert (prob.dim, prob.noise_dim, prob.sigma_kind) == (jprob.dim, jprob.noise_dim,
                                                           jprob.sigma_kind)
    assert prob.has_post_step and jprob.has_post_step
    assert prob.has_output_transform == jprob.has_output_transform
    np.testing.assert_array_equal(prob.x0.numpy(), np.asarray(jprob.x0))
    assert prob.x0.dtype == torch.float32 and prob.x0.device.type == "cpu"
    t, X, Y, Z, raw = _states()
    tt, Xt, Yt, Zt, rt = (torch.from_numpy(a) for a in (t, X, Y, Z, raw))
    pairs = {
        "mu": (prob.mu(tt, Xt, Yt, Zt), jprob.mu(t, X, Y, Z)),
        "sigma": (prob.sigma(tt, Xt, Yt), jprob.sigma(t, X, Y)),
        "phi": (prob.phi(tt, Xt, Yt, Zt), jprob.phi(t, X, Y, Z)),
        "g": (prob.g(Xt), jprob.g(X)),
        "Dg": (prob.Dg(Xt), jprob.Dg(jnp.asarray(X))),
        "post_step": (prob.post_step(tt, Xt), jprob.post_step(t, X)),
        "transform_u": (prob.transform_u(tt, Xt, rt), jprob.transform_u(t, X, raw)),
    }
    if case.startswith("barrier"):
        pairs["monitor"] = (prob.monitor(Xt[:, :1]), jprob.monitor(X[:, :1]))
    for key, (ours, ref) in pairs.items():
        ref = np.asarray(ref)
        assert np.isfinite(ours.numpy()).all(), key
        assert ours.dtype == torch.float32, key
        _close(ours.numpy(), ref, 1e-6)


def test_hard_monitor_is_the_indicator():
    prob = UpAndOutCall(smooth_beta=None)
    S = torch.tensor([[1.0], [1.2999], [1.3], [1.5]])
    np.testing.assert_array_equal(prob.monitor(S).numpy()[:, 0], [1.0, 1.0, 0.0, 0.0])
    assert prob.monitor(S.double()).dtype == torch.float64


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


@pytest.mark.parametrize("objective", ["local", "global"])
@pytest.mark.parametrize("case", ["barrier-smooth", "asian", "lookback"])
def test_three_trainer_iterations_match_jax_on_its_increments(case, objective):
    jprob, prob = CASES[case]
    layers = [3, 16, 16, 1]
    kw = dict(M=8, N=N_TRAIN, layers=layers, seed=0, objective=objective)
    jtr = JaxTrainer(jprob, **kw)
    tr = Trainer(prob, **kw, device="cpu")
    src = from_flax_params(jax.tree.map(np.asarray, jtr.params), "Sine", device="cpu")
    with torch.no_grad():
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    draws = iter(_jax_draws(jtr, 3))
    tr._increments = lambda n: torch.from_numpy(next(draws))
    rj = jtr.train(3, 1e-3, log_every=1, verbose=False)
    rp = tr.train(3, 1e-3, log_every=1, verbose=False)
    for i in range(3):
        _close(rp.graph[1][i], rj.graph[1][i], 1e-5 * max(i, 1))
        _close(rp.y0_history[i], rj.y0_history[i], 1e-5 * max(i, 1))
