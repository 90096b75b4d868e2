"""The port's implied volatility against the JAX package's: the Heston smile's
σ within 1e-5 (absolute) of JAX's on 23 strikes × 3 maturities, the
implicit-function gradients (price, S, K, T, r; scalar and array primals)
within 1e-4 relative of ``jax.grad``, and ``tests/test_implied_vol.py``'s
checks at its tolerances (round trip, edge clamps, 1/vega, strike
finite difference, smile shape, broadcast cotangents)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.numerics import HestonParams as JaxHestonParams
from dnnpde_tpu.numerics import black_scholes_call as jax_bs_call
from dnnpde_tpu.numerics import heston_call_price as jax_heston_call_price
from dnnpde_tpu.numerics import implied_vol as jax_implied_vol
from dnnpde_tpu_torch.numerics import (
    HestonParams,
    black_scholes_call,
    bs_vega,
    heston_call_price,
    implied_vol,
)

STRIKES = np.linspace(0.75, 1.3, 23)  # SurfaceConfig's strikes
MATURITIES = (1.0, 0.5, 0.25)


def _iv(*args, **kw):
    return implied_vol(*args, device="cpu", **kw)


def _heston_prices(T):
    hp = JaxHestonParams()
    return np.asarray([float(jax_heston_call_price(1.0, hp.v0, JaxHestonParams(
        K=float(k), r=hp.r, T=T, kappa=hp.kappa, theta=hp.theta, sigma=hp.sigma,
        rho=hp.rho, v0=hp.v0))) for k in STRIKES])


@pytest.mark.parametrize("T", MATURITIES)
def test_smile_matches_jax(T):
    prices = _heston_prices(T)
    ref = np.asarray(jax_implied_vol(prices, 1.0, STRIKES, T, JaxHestonParams().r))
    ours = _iv(prices, 1.0, STRIKES, T, HestonParams().r).numpy()
    assert ours.dtype == np.float32 and ours.shape == (23,)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_gradients_match_jax():
    """All five cotangents on array primals, and on scalar (broadcast)
    primals, within 1e-4 relative of jax.grad."""
    rng = np.random.default_rng(0)
    S = rng.uniform(0.8, 1.2, 7).astype(np.float32)
    K = rng.uniform(0.8, 1.2, 7).astype(np.float32)
    sig = rng.uniform(0.15, 0.6, 7).astype(np.float32)
    T, r = 0.7, 0.03
    price = np.asarray(jax.vmap(lambda s, k, v: jax_bs_call(s, k, T, r, v))(S, K, sig))

    def jax_loss(p, s, k, t, rr):
        return jnp.sum(jax_implied_vol(p, s, k, t, rr) ** 2)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(price, S, K, jnp.float32(T),
                                                       jnp.float32(r))
    args = [torch.tensor(a, requires_grad=True) for a in (price, S, K, np.float32(T),
                                                          np.float32(r))]
    (_iv(*args) ** 2).sum().backward()
    for a, g in zip(args, ref):
        assert a.grad.shape == a.shape
        g = np.asarray(g)
        np.testing.assert_allclose(a.grad.numpy(), g, rtol=1e-4, atol=1e-4 * np.abs(g).max())


def test_roundtrip_batched():
    rng = np.random.default_rng(0)
    n = 256
    S = rng.uniform(0.5, 2.0, n).astype(np.float32)
    K = rng.uniform(0.5, 2.0, n).astype(np.float32)
    T = rng.uniform(0.1, 3.0, n).astype(np.float32)
    sig = rng.uniform(0.05, 1.5, n).astype(np.float32)
    r = 0.03
    price = torch.stack([black_scholes_call(torch.tensor(s), float(k), torch.tensor(t), r,
                                            float(v)) for s, k, t, v in zip(S, K, T, sig)])
    intrinsic = np.maximum(S - K * np.exp(-r * T), 0.0)
    ok = (price.numpy() - intrinsic) > 1e-4
    assert ok.sum() > 200
    iv = _iv(price, S, K, T, np.full_like(S, r)).numpy()
    np.testing.assert_allclose(iv[ok], sig[ok], rtol=2e-3, atol=2e-4)


def test_edge_clamps_no_nans():
    iv_low = float(_iv(0.0, 1.0, 1.0, 1.0, 0.0))
    iv_deep = float(_iv(0.05, 1.5, 1.0, 1.0, 0.0))
    iv_high = float(_iv(0.999, 1.0, 1.0, 1.0, 0.0))
    assert iv_low == pytest.approx(1e-4, abs=2e-3)
    assert iv_deep == pytest.approx(1e-4, abs=2e-3)
    assert iv_high > 4.0
    assert np.isfinite([iv_low, iv_deep, iv_high]).all()
    # deep out of the money, where vega is tiny: finite, and JAX's value
    deep = _iv([1e-6, 1e-9], 1.0, [2.0, 3.0], 1.0, 0.0).numpy()
    np.testing.assert_allclose(deep, np.asarray(jax_implied_vol(
        np.asarray([1e-6, 1e-9], np.float32), 1.0, np.asarray([2.0, 3.0]), 1.0, 0.0)),
        rtol=0, atol=1e-5)


def test_gradient_is_inverse_vega():
    S, K, T, r, sig = 1.0, 1.05, 0.7, 0.02, 0.35
    price = torch.tensor(float(black_scholes_call(torch.tensor(S), K, torch.tensor(T), r, sig)),
                         requires_grad=True)
    _iv(price, S, K, T, r).backward()
    vega = float(bs_vega(S, K, T, r, sig, device="cpu"))
    assert float(price.grad) == pytest.approx(1.0 / vega, rel=1e-3)


def test_gradient_wrt_strike_matches_finite_difference():
    S, T, r, sig = 1.0, 1.0, 0.05, 0.4
    price = float(black_scholes_call(torch.tensor(S), 1.0, torch.tensor(T), r, sig))
    K = torch.tensor(1.0, requires_grad=True)
    _iv(price, S, K, T, r).backward()
    eps = 1e-3
    fd = (float(_iv(price, S, 1.0 + eps, T, r)) - float(_iv(price, S, 1.0 - eps, T, r))) / (2 * eps)
    assert float(K.grad) == pytest.approx(fd, rel=5e-3)


def test_heston_smile_has_the_right_shape():
    hp = HestonParams()
    Ks = np.asarray([0.8, 0.9, 1.0, 1.1, 1.2], np.float32)
    prices = np.asarray([float(heston_call_price(1.0, hp.v0, HestonParams(
        K=float(k), r=hp.r, T=hp.T, kappa=hp.kappa, theta=hp.theta, sigma=hp.sigma,
        rho=hp.rho, v0=hp.v0), device="cpu")) for k in Ks])
    ivs = _iv(prices, 1.0, Ks, hp.T, hp.r).numpy()
    assert np.all(np.isfinite(ivs)) and np.all(ivs > 0.2)
    assert ivs[-1] > ivs[0]
    assert abs(ivs[2] - np.sqrt(hp.v0)) < 0.05


def test_gradient_broadcast_shapes_reduce_to_primal():
    r = 0.02
    S = torch.tensor([0.9, 1.0, 1.1])
    sig = [0.4, 0.3, 0.35]
    T0 = 0.8
    prices = torch.stack([black_scholes_call(S[i], 1.0, torch.tensor(T0), r, sig[i])
                          for i in range(3)]).detach()

    def f(T):
        return _iv(prices, S, 1.0, T, r).sum()

    T = torch.tensor(T0, requires_grad=True)
    f(T).backward()
    assert T.grad.shape == ()
    eps = 1e-3
    fd = (float(f(torch.tensor(T0 + eps))) - float(f(torch.tensor(T0 - eps)))) / (2 * eps)
    assert float(T.grad) == pytest.approx(fd, rel=5e-3, abs=5e-4)
    Sg = S.clone().requires_grad_(True)
    _iv(prices, Sg, 1.0, T0, r).sum().backward()
    assert Sg.grad.shape == S.shape
