"""The port's Monte-Carlo pricers (``numerics/monte_carlo.py``) against the
JAX package and the Black–Scholes closed form. The two draw different
normals (torch's generator, threefry), so prices are compared within
standard errors."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dnnpde_tpu.numerics import monte_carlo as jmc
from dnnpde_tpu.sim import cholesky_factor, generate_correlation_matrix
from dnnpde_tpu_torch.numerics import (
    basket_call_mc,
    basket_delta_mc,
    basket_price_paths_mc,
    black_scholes_call,
    black_scholes_delta,
    hjb_exact_mc,
)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("payoff", ["mean", "sum", "weighted"])
@pytest.mark.parametrize("correlated", [False, True])
def test_basket_call_mc_matches_jax_within_se(payoff, correlated):
    D, n = 4, 40000
    S0 = np.linspace(0.9, 1.1, D).astype(np.float32)
    K = {"mean": 1.0, "sum": 4.0, "weighted": 1.0}[payoff]
    w = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    chol = None
    if correlated:
        chol = cholesky_factor(generate_correlation_matrix(D, "random_correlation", seed=2))
    p, se = basket_call_mc(_gen(1), S0, K, 1.0, 0.05, 0.2, chol=chol, weights=w,
                           num_paths=n, payoff=payoff)
    pj, sej = jmc.basket_call_mc(jax.random.PRNGKey(1), S0, K, 1.0, 0.05, 0.2, chol=chol,
                                 weights=w, num_paths=n, payoff=payoff)
    assert p.shape == () and se.shape == ()
    assert abs(float(p) - float(pj)) < 4 * np.hypot(float(se), float(sej))
    np.testing.assert_allclose(float(se), float(sej), rtol=0.1)  # the same spread


def test_basket_call_mc_d1_matches_black_scholes():
    p, se = basket_call_mc(_gen(4), [1.0], 1.0, 1.0, 0.05, 0.2, num_paths=100000,
                           antithetic=False, payoff="sum")
    exact = float(black_scholes_call(1.0, 1.0, 1.0, 0.05, 0.2, device="cpu"))
    assert abs(float(p) - exact) < 4 * float(se)


def test_basket_call_mc_drift_and_unknown_payoff():
    # drift 2r, discount r: e^{-rT} E[max(S_T - K, 0)] at drift 2r = e^{rT} BS(r=2r)
    p, se = basket_call_mc(_gen(5), [1.0], 1.0, 1.0, 0.05, 0.2, num_paths=100000,
                           payoff="sum", drift=0.1)
    exact = np.exp(0.05) * float(black_scholes_call(1.0, 1.0, 1.0, 0.1, 0.2, device="cpu"))
    assert abs(float(p) - exact) < 4 * float(se)
    with pytest.raises(ValueError, match="unknown payoff"):
        basket_call_mc(_gen(5), [1.0], 1.0, 1.0, 0.05, 0.2, num_paths=10, payoff="max")


def test_basket_delta_mc_d1_matches_black_scholes_delta():
    gen = _gen(6)
    delta = basket_delta_mc(gen, [1.0], 1.0, 1.0, 0.05, 0.2, num_paths=100000, payoff="sum")
    exact = float(black_scholes_delta(1.0, 1.0, 1.0, 0.05, 0.2, device="cpu"))
    assert delta.shape == (1,)
    # common random numbers: the bump difference is smooth, well inside 1 %
    assert abs(float(delta[0]) - exact) < 0.01


def test_basket_delta_mc_uses_common_random_numbers():
    """Every bumped pricing restarts from the generator's state at the call,
    so a zero bump gives exactly zero deltas and two calls from the same
    state agree exactly."""
    S0 = [1.0, 0.9, 1.1]
    state = _gen(7).get_state()
    gen = torch.Generator()
    gen.set_state(state)
    a = basket_delta_mc(gen, S0, 1.0, 1.0, 0.05, 0.2, num_paths=2000)
    gen.set_state(state)
    b = basket_delta_mc(gen, S0, 1.0, 1.0, 0.05, 0.2, num_paths=2000)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (3,) and bool((a > 0).all()) and float(a.sum()) < 1.0
    jd = jmc.basket_delta_mc(jax.random.PRNGKey(7), np.array(S0, np.float32), 1.0, 1.0, 0.05,
                             0.2, num_paths=2000)
    np.testing.assert_allclose(a.numpy(), np.asarray(jd), atol=0.05)  # MC noise at 2000 paths


def test_basket_price_paths_mc_matches_jax():
    t, path = basket_price_paths_mc(_gen(8), [1.0, 1.0], 1.0, 1.0, 0.05, 0.2, N=5,
                                    num_paths=20000)
    tj, pathj = jmc.basket_price_paths_mc(jax.random.PRNGKey(8), np.ones(2, np.float32), 1.0,
                                          1.0, 0.05, 0.2, N=5, num_paths=20000)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=1e-6, atol=1e-7)
    assert path.shape == (6,)
    # at t = 0 the intrinsic of the forward basket exactly; later, MC noise
    np.testing.assert_allclose(float(path[0]), float(pathj[0]), rtol=1e-5)
    np.testing.assert_allclose(path.numpy(), np.asarray(pathj), atol=5e-3)


@pytest.mark.parametrize("t", [0.0, 0.5, 1.0])
def test_hjb_exact_mc_matches_jax_within_se(t):
    x = np.linspace(-0.5, 0.5, 5).astype(np.float32)
    n = 40000
    u = hjb_exact_mc(_gen(9), t, x, num_samples=n)
    uj = jmc.hjb_exact_mc(jax.random.PRNGKey(9), t, x, num_samples=n)
    # the standard error of −log mean(exp(−g)), by the delta method
    g = np.log(0.5 + 0.5 * ((x + np.sqrt(2 * (1 - t)) * np.random.default_rng(0).normal(
        size=(n, 5))) ** 2).sum(-1))
    se = np.exp(-g).std() / np.sqrt(n) / np.exp(-g).mean()
    assert abs(float(u) - float(uj)) < 4 * np.sqrt(2) * se + 1e-6
    if t == 1.0:  # at T: −log exp(−g(x)) = g(x) exactly
        np.testing.assert_allclose(float(u), np.log(0.5 + 0.5 * (x**2).sum()), rtol=1e-5)
