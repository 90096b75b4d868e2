"""The port's optimal-stopping problems and their helpers against the JAX
package's, on the CPU: every problem method on the same numpy inputs
(within 1e-6 of max(1, max|ref|)), the heads at τ = 0 included; the
metadata (``exercise_every``, ``r_hat``, ``N_samples``, ``value_u``) and
the validation errors; ``crr_binomial`` to 1e-12; ``probe_linear_driver``'s
rates and refusals; ``bs_vega`` and ``iv_space_weights`` within 1e-6; the
X0 samplers' argument checks and moments."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.numerics import crr_binomial as jax_crr
from dnnpde_tpu.numerics.discrete_bsde import probe_linear_driver as jax_probe
from dnnpde_tpu.numerics.implied_vol import bs_vega as jax_bs_vega
from dnnpde_tpu.pde import AmericanPutOption as JaxAmericanPut
from dnnpde_tpu.pde import BermudanMaxCall as JaxMaxCall
from dnnpde_tpu.pde import HestonAmericanPut as JaxHestonAmerican
from dnnpde_tpu.sim import gaussian_x0 as jax_gaussian_x0
from dnnpde_tpu.sim import lognormal_x0 as jax_lognormal_x0
from dnnpde_tpu.solver import iv_space_weights as jax_iv_space_weights
from dnnpde_tpu_torch.numerics import bs_vega, crr_binomial, probe_linear_driver
from dnnpde_tpu_torch.pde import (
    AmericanPutOption,
    BermudanMaxCall,
    BlackScholesBarenblatt,
    CallOption1D,
    HamiltonJacobiBellman,
    HestonAmericanPut,
    HestonPDE,
)
from dnnpde_tpu_torch.sim import gaussian_x0, lognormal_x0
from dnnpde_tpu_torch.solver import iv_space_weights

B = 24

CASES = {
    "american-put-head": (JaxAmericanPut(), AmericanPutOption()),
    "american-put-plain": (JaxAmericanPut(bs_head=False, strike=1.1),
                           AmericanPutOption(bs_head=False, strike=1.1)),
    "american-put-3d-plain": (JaxAmericanPut(D=3, bs_head=False),
                              AmericanPutOption(D=3, bs_head=False)),
    "max-call-d2": (JaxMaxCall(), BermudanMaxCall()),
    "max-call-d3-sparse": (JaxMaxCall(D=3, N_steps=18), BermudanMaxCall(D=3, N_steps=18)),
    "max-call-plain": (JaxMaxCall(head=False), BermudanMaxCall(head=False)),
    "heston-american-bs": (JaxHestonAmerican(), HestonAmericanPut()),
    "heston-american-bs-erf": (JaxHestonAmerican(bs_cdf="erf"), HestonAmericanPut(bs_cdf="erf")),
    "heston-american-plain": (JaxHestonAmerican(clamp_output=False),
                              HestonAmericanPut(clamp_output=False)),
}


def _inputs(name, dim, seed=0):
    rng = np.random.default_rng(seed)
    T = 3.0 if name.startswith("max-call") else 1.0
    t = rng.uniform(0.0, T, size=(B, 1)).astype(np.float32)
    t[:4] = T  # τ = 0: the heads' terminal values
    if name.startswith("heston"):
        X = np.concatenate([rng.uniform(0.5, 1.5, size=(B, 1)),
                            rng.uniform(-0.05, 0.4, size=(B, 1))], axis=1)
    elif name.startswith("max-call"):
        X = np.log(100.0) + 0.3 * rng.normal(size=(B, dim))
    else:
        X = rng.uniform(0.5, 1.5, size=(B, dim))
    X = X.astype(np.float32)
    Y = rng.normal(size=(B, 1)).astype(np.float32)
    Z = rng.normal(size=(B, dim)).astype(np.float32)
    raw = (0.5 * rng.normal(size=(B, 1))).astype(np.float32)
    return t, X, Y, Z, raw


def _within(ours, ref, key):
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    assert np.isfinite(ours).all(), key
    assert ours.shape == ref.shape, key
    assert np.abs(ours - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max()), key


@pytest.mark.parametrize("name", list(CASES))
def test_problem_methods_match_jax(name):
    jprob, prob = CASES[name]
    assert dataclasses.asdict(prob) == dataclasses.asdict(jprob)
    for attr in ("dim", "noise_dim", "sigma_kind", "clamp_u", "has_output_transform",
                 "early_exercise", "exercise_every"):
        assert getattr(prob, attr) == getattr(jprob, attr), attr
    for attr in ("r_hat", "N_samples", "K", "dt"):
        assert getattr(prob, attr, None) == getattr(jprob, attr, None), attr
    np.testing.assert_allclose(prob.x0.numpy(), np.asarray(jprob.x0), rtol=1e-7)
    t, X, Y, Z, raw = _inputs(name, prob.dim)
    tt, Xt, Yt, Zt, rt = (torch.from_numpy(a) for a in (t, X, Y, Z, raw))
    pairs = {
        "mu": (prob.mu(tt, Xt, Yt, Zt), jprob.mu(t, X, Y, Z)),
        "sigma": (prob.sigma(tt, Xt, Yt), jprob.sigma(t, X, Y)),
        "phi": (prob.phi(tt, Xt, Yt, Zt), jprob.phi(t, X, Y, Z)),
        "g": (prob.g(Xt), jprob.g(X)),
        "Dg": (prob.Dg(Xt), jprob.Dg(jnp.asarray(X))),
        "transform_u": (prob.transform_u(tt, Xt, rt), jprob.transform_u(t, X, raw)),
        "value_u": (prob.value_u(Xt, rt), jprob.value_u(X, raw)),
    }
    for key, (ours, ref) in pairs.items():
        _within(ours, ref, key)


def test_heads_are_exact_at_maturity():
    """At τ = 0 each head is the payoff: the American put's European put,
    the max-call's max of BS calls, the Heston put's BS put (tanh-Φ: within
    2e-4 of the payoff where it has a kink)."""
    for prob, X, T in ((AmericanPutOption(), torch.tensor([[0.8], [1.0], [1.3]]), 1.0),
                       (BermudanMaxCall(), torch.log(torch.tensor([[90.0, 120.0],
                                                                   [80.0, 95.0]])), 3.0),
                       (HestonAmericanPut(), torch.tensor([[0.8, 0.2], [1.2, 0.2]]), 1.0)):
        u = prob.transform_u(torch.full((X.shape[0], 1), T), X, torch.full((X.shape[0], 1), 7.0))
        torch.testing.assert_close(u, prob.g(X), rtol=0, atol=2e-4)


def test_validation_errors_match_jax():
    with pytest.raises(ValueError, match="multiple of"):
        BermudanMaxCall(N_steps=20)
    with pytest.raises(ValueError, match="D=1"):
        AmericanPutOption(D=2).transform_u(torch.zeros(1, 1), torch.ones(1, 2), torch.zeros(1, 1))
    with pytest.raises(ValueError, match="bs head only"):
        HestonAmericanPut(clamp_smoothing="anchor").transform_u(
            torch.zeros(1, 1), torch.tensor([[1.0, 0.2]]), torch.zeros(1, 1))
    assert not CallOption1D().early_exercise and CallOption1D().exercise_every == 1
    u = torch.tensor([[0.1]])
    assert CallOption1D().value_u(torch.tensor([[3.0]]), u) is u  # identity for Europeans
    # the Snell read: max(g, u)
    assert float(AmericanPutOption().value_u(torch.tensor([[0.5]]), u)) == 0.5
    assert BermudanMaxCall().exercise_every == 5 and BermudanMaxCall().N_samples == 45
    p = BermudanMaxCall()
    assert abs((1.0 + p.r_hat * p.dt) - np.exp(p.r * p.dt)) < 1e-15


@pytest.mark.parametrize("kw", [
    dict(S0=1.0, K=1.0, T=1.0, r=0.06, sigma=0.2, n_steps=500),
    dict(S0=1.0, K=1.0, T=1.0, r=0.06, sigma=0.2, n_steps=4000, exercise_every=80),
    dict(S0=0.9, K=1.0, T=0.5, r=0.03, sigma=0.3, n_steps=301, american=False),
    dict(S0=100.0, K=100.0, T=3.0, r=0.05, sigma=0.2, n_steps=900, payoff="call",
         q=0.1, exercise_every=100),
    dict(S0=1.1, K=1.0, T=1.0, r=0.02, sigma=0.25, n_steps=7, payoff="call"),
])
def test_crr_binomial_matches_jax(kw):
    ours, ref = crr_binomial(**kw), jax_crr(**kw)
    assert isinstance(ours, float)
    assert abs(ours - ref) <= 1e-12 * max(1.0, abs(ref))


def test_crr_binomial_validation():
    for kw in (dict(payoff="straddle"), dict(n_steps=0), dict(exercise_every=0)):
        with pytest.raises(ValueError):
            crr_binomial(1.0, 1.0, 1.0, 0.06, 0.2, **kw)
    with pytest.raises(ValueError, match="up-probability"):
        crr_binomial(1.0, 1.0, 1.0, 0.5, 0.01, n_steps=2)


@pytest.mark.parametrize("jprob,prob", [
    (JaxAmericanPut(), AmericanPutOption()),
    (JaxMaxCall(), BermudanMaxCall()),
    (JaxHestonAmerican(), HestonAmericanPut()),
])
def test_probe_linear_driver_rates_match_jax(jprob, prob):
    assert abs(probe_linear_driver(prob) - jax_probe(jprob)) <= 1e-7


@pytest.mark.parametrize("prob,match", [
    (BlackScholesBarenblatt(D=3), "depends on Z"),
    (HamiltonJacobiBellman(D=3), "constant term|not linear|depends on Z"),
])
def test_probe_linear_driver_refuses_what_jax_refuses(prob, match):
    with pytest.raises(ValueError, match=match):
        probe_linear_driver(prob)


def test_probe_rejects_heston_call_with_clamped_drift_only_when_jax_does():
    for prob in (HestonPDE(), HestonAmericanPut(clamp_output=False)):
        assert abs(probe_linear_driver(prob) - 0.05) < 1e-7


def test_bs_vega_and_iv_space_weights_match_jax():
    rng = np.random.default_rng(4)
    S = rng.uniform(0.3, 2.0, size=64).astype(np.float32)
    sig = rng.uniform(0.05, 0.6, size=64).astype(np.float32)
    T = rng.uniform(0.0, 2.0, size=64).astype(np.float32)
    ours = bs_vega(torch.from_numpy(S), 1.0, torch.from_numpy(T), 0.03, torch.from_numpy(sig),
                   q=0.01)
    _within(ours, jax_bs_vega(S, 1.0, T, 0.03, sig, q=0.01), "bs_vega")
    _within(bs_vega(torch.from_numpy(S), 1.1, 0.7, 0.03, 0.25),
            jax_bs_vega(S, 1.1, 0.7, 0.03, 0.25), "bs_vega numbers")
    for X0 in (np.stack([S, sig**2], axis=1), S[:, None]):
        for kw in ({}, dict(strike=1.2, T=0.5, r=0.05, vega_floor=0.05)):
            w = iv_space_weights(**kw)(torch.from_numpy(X0))
            _within(w, jax_iv_space_weights(**kw)(jnp.asarray(X0)), "iv_space_weights")
            assert abs(float(w.mean()) - 1.0) < 1e-6


def test_x0_samplers_check_their_arguments_as_jax_does():
    for bad in (dict(x0=[1.0, 0.2], scale=[0.1, 0.2, 0.3]), dict(x0=[1.0], scale=0.0),
                dict(x0=[1.0, 0.2], scale=[0.1, -0.2])):
        for fn in (lognormal_x0, jax_lognormal_x0):
            with pytest.raises(ValueError, match="scale"):
                fn(**bad)
    for fn in (gaussian_x0, jax_gaussian_x0):
        with pytest.raises(ValueError, match="positive"):
            fn([0.0, 0.0], 0.0)


def test_x0_samplers_draw_on_the_generators_device_with_the_right_moments():
    gen = torch.Generator().manual_seed(0)
    X = lognormal_x0([1.0, 0.2], [0.1, 0.4])(gen, 200_000)
    assert X.shape == (200_000, 2) and X.dtype == torch.float32 and bool((X > 0).all())
    np.testing.assert_allclose(X.double().mean(0).numpy(), [1.0, 0.2], rtol=5e-3)
    np.testing.assert_allclose(torch.log(X).double().std(0).numpy(), [0.1, 0.4], rtol=1e-2)
    Xg = gaussian_x0([0.0, 1.0, 2.0], 0.5)(gen, 200_000)
    np.testing.assert_allclose(Xg.double().mean(0).numpy(), [0.0, 1.0, 2.0], atol=5e-3)
    np.testing.assert_allclose(Xg.double().std(0).numpy(), [0.5] * 3, rtol=1e-2)
    # the same generator state draws the same batch
    s = lognormal_x0(1.0, 0.2)
    a = s(torch.Generator().manual_seed(3), 8)
    b = s(torch.Generator().manual_seed(3), 8)
    assert torch.equal(a, b) and a.shape == (8, 1)
