"""The port's Black–Scholes closed forms (``numerics/black_scholes.py``)
against the JAX package on the same inputs, including T = 0 and both cdfs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dnnpde_tpu.numerics import black_scholes as jbs
from dnnpde_tpu_torch.numerics import black_scholes as pbs

# f32 math in both frameworks; Φ is jax.scipy's norm.cdf against
# torch.special.ndtr, which differ in the last places
RTOL, ATOL = 2e-5, 2e-6


def _grid():
    rng = np.random.default_rng(7)
    S = rng.uniform(0.5, 1.5, size=(6, 5)).astype(np.float32)
    T = np.array([0.0, 1e-13, 0.1, 0.5, 2.0], np.float32)
    return S, T


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("cdf", ["erf", "tanh"])
@pytest.mark.parametrize("q", [0.0, 0.02])
def test_black_scholes_call_matches_jax(cdf, q):
    S, T = _grid()
    port = pbs.black_scholes_call(torch.from_numpy(S), 1.0, torch.from_numpy(T), 0.05, 0.2,
                                  q=q, cdf=cdf)
    _close(port, jbs.black_scholes_call(S, 1.0, T, 0.05, 0.2, q=q, cdf=cdf))
    # T = 0 (and below the 1e-12 floor): the intrinsic value
    np.testing.assert_array_equal(port[:, :2].numpy(), np.maximum(S[:, :2] - 1.0, 0.0))


def test_black_scholes_call_scalar_needs_a_device():
    ref = float(jbs.black_scholes_call(1.0, 1.0, 1.0, 0.05, 0.2))
    got = pbs.black_scholes_call(1.0, 1.0, 1.0, 0.05, 0.2, device="cpu")
    assert got.device.type == "cpu" and got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=RTOL)


def test_black_scholes_delta_matches_jax():
    S, T = _grid()
    port = pbs.black_scholes_delta(torch.from_numpy(S), 1.0, torch.from_numpy(T), 0.05, 0.2)
    _close(port, jbs.black_scholes_delta(S, 1.0, T, 0.05, 0.2))
    np.testing.assert_array_equal(port[:, 0].numpy(), (S[:, 0] > 1.0).astype(np.float32))


def test_call_price_grid_matches_jax():
    S, _ = _grid()
    t = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    port = pbs.call_price_grid(torch.from_numpy(S), torch.from_numpy(t), 1.1, 1.0, 0.03, 0.25)
    ref = jbs.call_price_grid(S, t, 1.1, 1.0, 0.03, 0.25)
    for a, b in zip(port, ref):
        assert a.shape == (6, 5)
        _close(a, b)


def test_basket_analytical_approx_matches_jax():
    S0 = np.linspace(0.8, 1.2, 10).astype(np.float32)
    port = pbs.basket_analytical_approx(torch.from_numpy(S0), 1.0, 1.0, 0.05, 0.2, 10)
    _close(port, jbs.basket_analytical_approx(S0, 1.0, 1.0, 0.05, 0.2, 10))


@pytest.mark.parametrize("N", [1, 12, 250])
def test_geometric_asian_call_matches_jax(N):
    port = pbs.geometric_asian_call(1.0, 0.95, 1.0, 0.05, 0.25, N, device="cpu")
    assert isinstance(port, float)
    _close(port, jbs.geometric_asian_call(1.0, 0.95, 1.0, 0.05, 0.25, N))


def test_lookback_call_floating_matches_jax():
    port = pbs.lookback_call_floating(1.0, 1.0, 0.05, 0.3, device="cpu")
    assert isinstance(port, float)
    _close(port, jbs.lookback_call_floating(1.0, 1.0, 0.05, 0.3))


def test_bsb_exact_solution_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.uniform(0.5, 1.5, size=(4, 7)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, size=(4, 1)).astype(np.float32)
    port = pbs.bsb_exact_solution(torch.from_numpy(t), torch.from_numpy(X), T=1.0)
    _close(port, jbs.bsb_exact_solution(t, X, T=1.0))
    # at t = T the terminal condition ΣX²
    _close(pbs.bsb_exact_solution(1.0, torch.from_numpy(X), T=1.0), (X**2).sum(-1, keepdims=True))
