"""The port's Trainer under the local objectives against the JAX Trainer, on
the CPU: three iterations fed the increments (and initial states) the JAX
Trainer draws, for ``objective="local"``, ``"local_ema"`` and an
``x0_sampler`` under ``antithetic`` (each logged value and each parameter
within 1e-5 of max|ref| per optimizer step taken before it, as
``test_torch_hjb_heston.py`` holds three iterations); the Trainer's
config rules and errors; and a training chunk equal, bit for bit, to the
same number of eager ``step`` calls when every new feature is on."""

from __future__ import annotations

import warnings

import jax
import numpy as np
import pytest
import torch

from dnnpde_tpu.pde import AmericanPutOption as JaxAmericanPut
from dnnpde_tpu.pde import BermudanMaxCall as JaxMaxCall
from dnnpde_tpu.pde import HestonAmericanPut as JaxHestonAmerican
from dnnpde_tpu.sim import lognormal_x0 as jax_lognormal_x0
from dnnpde_tpu.sim.brownian import brownian_increments as jax_increments
from dnnpde_tpu.solver import iv_space_weights as jax_iv_space_weights
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import (
    AmericanPutOption,
    BermudanMaxCall,
    BlackScholesBarenblatt,
    HestonAmericanPut,
)
from dnnpde_tpu_torch.sim import lognormal_x0
from dnnpde_tpu_torch.solver import SolverConfig, iv_space_weights
from dnnpde_tpu_torch.train import Trainer


def _close(actual, reference, tol):
    actual, reference = np.asarray(actual, np.float64), np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.abs(actual - reference).max() <= tol * (np.abs(reference).max() + 1e-30)


def _jax_draws(jtr, n_iter, log_every, x0_half):
    """The increments (time-major) and the X0 draws (M/2 states under
    ``antithetic``, else M; None without a sampler) that JAX's
    ``train(n_iter, log_every=...)`` takes from ``jtr``'s key, in order:
    each iteration's key splits into (increments, net, X0)."""
    key, out, done = jtr.key, [], 0
    p = jtr.problem
    while done < n_iter:
        k = min(log_every, n_iter - done)
        key, sub = jax.random.split(key)
        for kk in jax.random.split(sub, k):
            kw, _, kx = jax.random.split(kk, 3)
            dW = jax_increments(kw, jtr.M, jtr.N, p.noise_dim, p.T / jtr.N, jtr.chol,
                                jtr.dtype, antithetic=jtr.antithetic)
            X0 = None
            if jtr.x0_sampler is not None:
                X0 = np.asarray(jtr.x0_sampler(kx, jtr.M // 2 if x0_half else jtr.M)).copy()
            out.append((np.swapaxes(np.asarray(dW), 0, 1).copy(), X0))
        done += k
    return out


def _feed(tr, draws):
    """Make the port trainer draw ``draws`` in order (its other work,
    the antithetic tiling of X0 included, unchanged)."""
    it = iter(draws)
    pending = []

    def increments(n):
        dWs, X0 = next(it)
        pending.append(X0)
        assert dWs.shape[0] == n
        return torch.from_numpy(dWs)

    def sampler(generator, m):
        X0 = torch.from_numpy(pending.pop(0))
        assert X0.shape[0] == m
        return X0

    tr._increments = increments
    if tr.x0_sampler is not None:
        tr.x0_sampler = sampler


CASES = {
    # name: (JAX problem, port problem, Trainer kwargs shared, M, N)
    "american-put-local": (JaxAmericanPut(), AmericanPutOption(),
                           dict(objective="local", ema_decay=0.9), 16, 5),
    "max-call-local-sparse": (JaxMaxCall(N_steps=6, n_exercise=3),
                              BermudanMaxCall(N_steps=6, n_exercise=3),
                              dict(objective="local"), 8, 6),
    "heston-american-local-ema": (JaxHestonAmerican(), HestonAmericanPut(),
                                  dict(objective="local_ema", ema_decay=0.5), 8, 4),
    "heston-american-x0-antithetic": (
        JaxHestonAmerican(), HestonAmericanPut(),
        dict(objective="local", antithetic=True, z_match_weight=0.5, z_match_mask=(0.0, 1.0)),
        16, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_trainer_iterations_match_jax_on_its_draws(case):
    jprob, prob, kw, M, N = CASES[case]
    layers = [prob.dim + 1, 16, 16, 16, 1]
    jkw, pkw = dict(kw), dict(kw)
    sampled = case.endswith("x0-antithetic")
    if sampled:
        jkw.update(x0_sampler=jax_lognormal_x0(jprob.x0, [0.1, 0.3]),
                   path_weight_fn=jax_iv_space_weights(r=0.05))
        pkw.update(x0_sampler=lognormal_x0(prob.x0, [0.1, 0.3]),
                   path_weight_fn=iv_space_weights(r=0.05))
    jtr = JaxTrainer(jprob, M=M, N=N, layers=layers, seed=0, **jkw)
    tr = Trainer(prob, M=M, N=N, layers=layers, seed=0, device="cpu", **pkw)
    assert tr.config.objective == jtr.config.objective == "local"
    src = from_flax_params(jax.tree.map(np.asarray, jtr.params), "sine", device="cpu")
    with torch.no_grad():
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    _feed(tr, _jax_draws(jtr, 3, 1, x0_half=sampled))
    rj = jtr.train(3, 1e-3, log_every=1, verbose=False)
    rp = tr.train(3, 1e-3, log_every=1, verbose=False)
    for i in range(3):
        _close(rp.graph[1][i], rj.graph[1][i], 1e-5 * max(i, 1))
        _close(rp.y0_history[i], rj.y0_history[i], 1e-5 * max(i, 1))
    nets = [(tr.params, jtr.params)]
    if kw.get("ema_decay"):
        nets.append((tr.ema_params, jtr.ema_params))
    for ours, ref in nets:
        ref_net = from_flax_params(jax.tree.map(np.asarray, ref), "sine", device="cpu")
        for a, r in zip(ours.parameters(), ref_net.parameters()):
            _close(a.detach().numpy(), r.detach().numpy(), 3e-5)


def test_trainer_config_rules_match_jax():
    kw = dict(M=4, N=4, layers=[2, 8, 1], device="cpu")
    with pytest.raises(ValueError, match="objective must be"):
        Trainer(AmericanPutOption(), objective="backward", **kw)
    with pytest.raises(ValueError, match="requires ema_decay"):
        Trainer(AmericanPutOption(), objective="local_ema", **kw)
    with pytest.raises(ValueError, match="early_exercise"):
        Trainer(AmericanPutOption(), **kw)  # the global objective
    with pytest.raises(ValueError, match="N_samples"):
        Trainer(BermudanMaxCall(D=1, N_steps=9), objective="local", **kw)
    with pytest.warns(UserWarning, match="systematically"):
        Trainer(BlackScholesBarenblatt(D=1), x0_sampler=lognormal_x0([1.0], 0.1), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Trainer(AmericanPutOption(), objective="local", x0_sampler=lognormal_x0([1.0], 0.1),
                **kw)
    tr = Trainer(AmericanPutOption(), objective="local_ema", ema_decay=0.9,
                 z_match_weight=0.3, z_match_mask=[1.0], **kw)
    assert tr.config.objective == "local" and tr._local_ema
    assert tr.config.z_match_weight == 0.3 and tr.config.z_match_mask == (1.0,)
    # a given config keeps its own fields and takes the arguments that are set
    w = iv_space_weights()
    tr = Trainer(AmericanPutOption(), objective="local", path_weight_fn=w,
                 solver_config=SolverConfig(remat=True, fused_net_u=False), **kw)
    assert tr.config.remat and tr.config.objective == "local" and tr.config.path_weight_fn is w


def test_chunk_equals_eager_steps_with_every_new_feature():
    """One ``train`` chunk (the iteration a card captures) against the same
    number of eager ``step`` calls on ``_batch()``: losses, Y0, parameters,
    EMA shadow and the generator, bit for bit, with local_ema, a lognormal
    X0 sampler under antithetic, Z-matching and IV-space weights."""
    def make():
        return Trainer(HestonAmericanPut(), M=8, N=4, layers=[3, 16, 16, 1], seed=3,
                       device="cpu", objective="local_ema", ema_decay=0.9, antithetic=True,
                       x0_sampler=lognormal_x0([1.0, 0.2], [0.1, 0.4]),
                       z_match_weight=0.5, z_match_mask=(0.0, 1.0),
                       path_weight_fn=iv_space_weights(r=0.05))
    a, b = make(), make()
    k = 4
    res = a.train(k, 1e-3, log_every=k, verbose=False)
    steps = [b.step(*b._batch(), "Adam", 1e-3) for _ in range(k)]
    chunk = next(iter(a._chunk_cache.values()))
    assert torch.equal(chunk.losses[:k], torch.stack([s[0] for s in steps]))
    assert torch.equal(chunk.y0s[:k], torch.stack([s[1] for s in steps]))
    assert res.y0_history[-1] == float(steps[-1][1])
    for x, y in zip(a._params, b._params):
        assert torch.equal(x, y)
    for x, y in zip(a.ema_params.parameters(), b.ema_params.parameters()):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_antithetic_x0_pairs_share_their_start():
    tr = Trainer(HestonAmericanPut(), M=8, N=4, layers=[3, 8, 1], seed=1, device="cpu",
                 objective="local", antithetic=True,
                 x0_sampler=lognormal_x0([1.0, 0.2], 0.2))
    ts, dWs, X0 = tr._batch()
    assert torch.equal(X0[:4], X0[4:]) and not torch.equal(X0[0], X0[1])
    assert torch.equal(dWs[:, :4], -dWs[:, 4:])


def test_short_local_runs_descend():
    """The stopping problems train under the local objective: the mean
    logged loss falls and the served value stays in a sane bracket."""
    for prob, N, lo, hi in ((AmericanPutOption(), 5, 0.03, 0.2),
                            (BermudanMaxCall(D=2, N_steps=9), 9, 5.0, 40.0)):
        tr = Trainer(prob, M=64, N=N, layers=[prob.dim + 1, 16, 16, 1], seed=0,
                     objective="local", device="cpu")
        res = tr.train(120, 1e-3, log_every=40, verbose=False)
        assert np.isfinite(res.graph[1]).all() and res.graph[1][-1] < res.graph[1][0]
        x0 = prob.x0[None]
        u, _ = tr.evaluate_u([[0.0]], x0)
        y0 = float(prob.value_u(x0, torch.from_numpy(u))[0, 0])
        assert lo < y0 < hi, y0
