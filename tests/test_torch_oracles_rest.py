"""The port's last oracles and analyses against the JAX package, on the CPU:
``numerics/{moments,fft_pricer,variance_gamma,calibration}.py``,
``sim/mlmc.py`` and ``evals/correlation_analysis.py``.

Tolerances:
- moment matching (float64 NumPy on both sides): 1e-12 relative;
- the FFT and VG prices (float32/complex64 on both sides, other summation
  orders): 2e-6 of the basket spot B0, and 1e-6 relative for the tables;
- the Heston calibration (the same Adam steps on the same closed form in
  float32): each loss of the history within 1e-4 of the first loss, each
  fitted parameter within 1e-4 relative (measured ≤ 1e-5); gradients of the
  closed form within 1e-4 relative of ``jax.grad``;
- the Monte-Carlo ones (different generators): within 4 combined standard
  errors (plus the Euler bias bound where the reference test allows one);
- otherwise the reference tests' own assertions
  (``tests/test_numerics.py:196,252,259``, ``tests/test_calibration.py``,
  ``tests/test_mlmc_greeks_corr.py``).
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch
from scipy import integrate

from dnnpde_tpu import numerics as jnum
from dnnpde_tpu.evals import correlation_analysis as jcorr
from dnnpde_tpu.sim import mlmc as jmlmc
from dnnpde_tpu_torch import numerics as num
from dnnpde_tpu_torch.evals import (
    RandomCorrelationSensitivityAnalysis,
    equicorrelation_sensitivity,
)
from dnnpde_tpu_torch.numerics import HestonParams
from dnnpde_tpu_torch.sim import (
    MLMCConfig,
    cholesky_factor,
    coupled_brownian_increments,
    generate_correlation_matrix,
    mlmc_gbm_price,
    mlmc_minibatch,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with several test workers on one host, PyTorch's
    default of one thread per core makes these small CPU ops many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = "cpu"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------- baskets
def test_moments_match_jax_exactly():
    C = generate_correlation_matrix(4, "random_correlation", seed=3)
    S0, w = np.array([1.0, 0.9, 1.2, 1.1]), np.array([0.1, 0.2, 0.3, 0.4])
    for corr, weights in ((None, None), (C, w)):
        ours = num.basket_moments(S0, 0.25, 1.5, 0.03, corr, weights)
        ref = jnum.basket_moments(S0, 0.25, 1.5, 0.03, corr, weights)
        np.testing.assert_allclose(ours, ref, rtol=1e-12)
        np.testing.assert_allclose(num.match_lognormal(*ours[:2]),
                                   jnum.match_lognormal(*ref[:2]), rtol=1e-12)
        for K in (0.8, 1.05, 1.3):
            assert num.moment_matched_basket_call(S0, K, 1.5, 0.03, 0.25, corr, weights) == \
                pytest.approx(jnum.moment_matched_basket_call(S0, K, 1.5, 0.03, 0.25, corr,
                                                              weights), rel=1e-12)


def test_fft_matches_jax_to_float32_rounding():
    C = generate_correlation_matrix(5, "restricted_random_correlation", seed=2)
    params = num.basket_lognormal_cf_params(np.ones(5), 0.2, C, None, 1.0)
    assert params == jnum.basket_lognormal_cf_params(np.ones(5), 0.2, C, None, 1.0)
    B0 = params[0]
    for K in (0.6, 0.8, 1.0, 1.2, 1.6):
        ours = num.fft_basket_call(np.ones(5), K, 1.0, 0.05, 0.2, corr=C, device=CPU)
        ref = jnum.fft_basket_call(np.ones(5), K, 1.0, 0.05, 0.2, corr=C)
        assert abs(ours - ref) <= 2e-6 * B0, (K, ours, ref)
    assert abs(num.carr_madan_call(1.0, 1.0, 1.0, 0.05, 0.2, device=CPU)
               - float(num.black_scholes_call(1.0, 1.0, 1.0, 0.05, 0.2, device=CPU))) < 1e-4


def test_fft_vs_mc_vs_moment_matching():
    D, K, T, r, sigma = 5, 1.0, 1.0, 0.05, 0.2
    C = generate_correlation_matrix(D, "restricted_random_correlation", seed=2)
    L = torch.from_numpy(cholesky_factor(C)).float()
    mc, se = num.basket_call_mc(_gen(0), np.ones(D), K, T, r, sigma, chol=L,
                                num_paths=400_000, payoff="mean")
    fft_p = num.fft_basket_call(np.ones(D), K, T, r, sigma, corr=C, device=CPU)
    mm_p = num.moment_matched_basket_call(np.ones(D), K, T, r, sigma, corr=C)
    assert fft_p == pytest.approx(float(mc), rel=0.05)
    assert mm_p == pytest.approx(float(mc), rel=0.05)
    assert abs(fft_p - mm_p) < 0.02


def test_vg_tables_match_jax():
    for (k, ours), (kr, ref) in zip(num.vg_table_2(device=CPU), jnum.vg_table_2()):
        assert k == kr and ours == pytest.approx(ref, rel=1e-6)
    ours, ref = num.vg_table_3(device=CPU), jnum.vg_table_3()
    assert [r[:2] for r in ours] == [r[:2] for r in ref]
    assert ours[0][2] == pytest.approx(ref[0][2], rel=1e-6)


def test_vg_pricer_finite_and_monotone_in_K():
    S0w = [(40.0, 1 / 3), (50.0, 1 / 3), (60.0, 1 / 3)]
    prices = [num.vg_basket_call(S0w, K, 1.0, 0.05, device=CPU) for K in (50.0, 55.0, 60.0)]
    assert all(np.isfinite(p) for p in prices)
    assert prices[0] >= prices[1] >= prices[2] >= 0
    assert num.VGParams() == num.VGParams(0.57, 0.75, -0.95)


def test_vg_matches_scipy_quad_formulation():
    sigma, nu, theta = 0.3477, 0.4932, -0.3919
    ours = num.vg_basket_call([(100.0, 0.5), (100.0, 0.5)], 105.13, 1.0, 0.05,
                              num.VGParams(sigma, nu, theta), device=CPU)
    B0 = 100.0
    omega = (1 / nu) * np.log(max(1e-10, 1 - theta * nu - 0.5 * sigma**2 * nu))

    def integrand(u):
        expo = 1j * u * (np.log(B0) + (0.05 + omega) * 1.0)
        denom = np.abs(1 - 1j * theta * nu * u + 0.5 * sigma**2 * nu * u**2) ** (1.0 / nu)
        return np.real(np.exp(-1j * u * np.log(105.13)) * np.exp(expo) / denom / (1j * u))

    integral, _ = integrate.quad(integrand, 1e-10, 1000, limit=3000)
    ref = max(B0 - 105.13 * np.exp(-0.05) * (0.5 + integral / np.pi), 0.0)
    assert ours == pytest.approx(ref, abs=5e-3)


# --------------------------------------------------------------- calibration
def _quotes(true: HestonParams, strikes, mats):
    return np.asarray([float(num.heston_call_price(
        1.0, true.v0, HestonParams(K=float(k), r=0.05, T=float(t), kappa=true.kappa,
                                   theta=true.theta, sigma=true.sigma, rho=true.rho,
                                   v0=true.v0), device=CPU)) for k, t in zip(strikes, mats)])


STRIKES = np.repeat([0.85, 0.95, 1.0, 1.05, 1.15], 3)
MATS = np.tile([0.5, 1.0, 2.0], 5)


def _same_fit(ours, ref):
    hist, ref_hist = ours.loss_history, ref.loss_history
    assert hist.shape == ref_hist.shape
    assert np.abs(hist - ref_hist).max() <= 1e-4 * ref_hist[0]
    for name in ("kappa", "theta", "sigma", "rho", "v0"):
        assert getattr(ours.params, name) == pytest.approx(getattr(ref.params, name), rel=1e-4)


def test_synthetic_recovery_matches_jax():
    true = HestonParams(kappa=1.5, theta=0.25, sigma=0.45, rho=0.5, v0=0.15)
    quotes = _quotes(true, STRIKES, MATS)
    res = num.calibrate_heston(1.0, STRIKES, MATS, quotes, r=0.05, n_iter=400, device=CPU)
    assert res.rmse_rel < 0.002, res.rmse_rel
    assert res.loss_history[-1] < 1e-2 * res.loss_history[0]
    assert abs(res.params.v0 - true.v0) < 0.02
    assert abs(res.params.rho - true.rho) < 0.25
    assert np.isfinite(res.feller)
    _same_fit(res, jnum.calibrate_heston(1.0, STRIKES, MATS, quotes, r=0.05, n_iter=400))


def test_lr_stages_follow_optax_piecewise_schedule():
    """The staged fit takes optax's steps: the 3-stage schedule's history
    and fit equal JAX's (the 14000-iteration flat-valley study of
    ``tests/test_calibration.py`` runs on the card, not here)."""
    true = HestonParams(kappa=2.0, theta=0.2, sigma=0.3, rho=0.8, v0=0.2)
    quotes = _quotes(true, STRIKES, MATS)
    init = HestonParams(kappa=1.2, theta=0.12, sigma=0.45, rho=0.4, v0=0.3)
    kw = dict(r=0.05, init=init, n_iter=300, lr=0.05, lr_stages=3)
    _same_fit(num.calibrate_heston(1.0, STRIKES, MATS, quotes, device=CPU, **kw),
              jnum.calibrate_heston(1.0, STRIKES, MATS, quotes, **kw))


def test_constraints_always_admissible():
    true = HestonParams(kappa=2.0, theta=0.2, sigma=0.3, rho=-0.7, v0=0.2)
    quotes = _quotes(true, STRIKES, MATS)
    p = num.calibrate_heston(1.0, STRIKES, MATS, quotes, r=0.05, n_iter=150, lr=0.2,
                             device=CPU).params
    assert p.kappa > 0 and p.theta > 0 and p.sigma > 0 and p.v0 > 0
    assert -1.0 < p.rho < 1.0


def test_shape_validation():
    with pytest.raises(ValueError, match="same length"):
        num.calibrate_heston(1.0, [1.0, 1.1], [1.0], [0.1, 0.2], r=0.05, device=CPU)
    with pytest.raises(ValueError, match="lr_stages"):
        num.calibrate_heston(1.0, [1.0], [1.0], [0.1], r=0.05, lr_stages=0, device=CPU)


def test_char_func_no_overflow_at_long_maturity():
    for sig in (0.5, 0.8, 1.2):
        hp = HestonParams(K=1.0, r=0.05, T=2.0, kappa=1.2, theta=0.12, sigma=sig, rho=0.4,
                          v0=0.3)
        v = float(num.heston_call_price(1.0, 0.3, hp, device=CPU))
        assert np.isfinite(v) and 0.2 < v < 0.5, (sig, v)
    hp = HestonParams(K=1.0, r=0.05, T=10.0, kappa=2.0, theta=0.2, sigma=0.6, rho=-0.7, v0=0.2)
    assert np.isfinite(float(num.heston_call_price(1.0, 0.2, hp, device=CPU)))


def test_pricer_is_differentiable_wrt_every_parameter():
    """The closed form carries autograd through κ, θ, σ_v, ρ and v0 (given
    as tensors) in its complex arithmetic; the gradients equal JAX's."""
    values = (2.0, 0.2, 0.3, 0.8, 0.2)
    ps = [torch.tensor(v, requires_grad=True) for v in values]
    hp = HestonParams(K=1.0, r=0.05, T=1.0, kappa=ps[0], theta=ps[1], sigma=ps[2], rho=ps[3],
                      v0=ps[4])
    g = np.asarray([float(x) for x in torch.autograd.grad(
        num.heston_call_price(1.0, ps[4], hp), ps)])

    def price(kappa, theta, sigma, rho, v0):
        return jnum.heston_call_price(1.0, v0, jnum.HestonParams(
            K=1.0, r=0.05, T=1.0, kappa=kappa, theta=theta, sigma=sigma, rho=rho, v0=v0))

    ref = np.asarray([float(x) for x in jax.grad(price, argnums=(0, 1, 2, 3, 4))(*values)])
    assert np.isfinite(g).all() and g[4] > 0.05 and g[1] > 0.05
    np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_vectorized_quote_grid_prices_like_one_quote_at_a_time():
    """The calibration's broadcast pricing (one strike and maturity per
    row) equals the scalar closed form quote by quote."""
    from dnnpde_tpu_torch.numerics.heston import _prob

    K = torch.tensor(STRIKES, dtype=torch.float32)
    T = torch.tensor(MATS, dtype=torch.float32)
    hp = HestonParams(K=K[:, None], r=0.05, T=T[:, None])
    S, v0 = torch.ones(len(K)), torch.tensor(0.2)
    grid = S * _prob(hp, S, v0, 1, 128) - K * torch.exp(-0.05 * T) * _prob(hp, S, v0, 2, 128)
    one = [float(num.heston_call_price(1.0, 0.2, HestonParams(K=float(k), T=float(t)),
                                       order=128, device=CPU)) for k, t in zip(STRIKES, MATS)]
    np.testing.assert_allclose(grid.numpy(), one, rtol=0, atol=2e-7)


# ---------------------------------------------------------------------- MLMC
def test_coupled_increments_exact_coarsening():
    dw_f, dw_c = coupled_brownian_increments(_gen(0), 8, 12, 3, 0.01, factor=4)
    assert dw_f.shape == (8, 12, 3) and dw_c.shape == (8, 3, 3)
    np.testing.assert_allclose(dw_c.numpy(), dw_f.numpy().reshape(8, 3, 4, 3).sum(axis=2),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        coupled_brownian_increments(_gen(0), 4, 10, 2, 0.1, factor=3)


def test_mlmc_price_matches_bs_and_jax():
    cfg = MLMCConfig(num_levels=4, M_const=2, N0=4, M0=200_000)
    price, se, diag = mlmc_gbm_price(_gen(0), np.ones(1), 1.0, 1.0, 0.05, 0.2, cfg,
                                     payoff="sum")
    exact = float(num.black_scholes_call(1.0, 1.0, 1.0, 0.05, 0.2, device=CPU))
    assert abs(float(price) - exact) < 4 * float(se) + 0.004
    assert diag[1]["var"] > diag[3]["var"]
    assert [diag[k]["M"] for k in range(4)] == [200_000, 100_000, 50_000, 25_000]
    ref, ref_se, _ = jmlmc.mlmc_gbm_price(jax.random.PRNGKey(0), np.ones(1), 1.0, 1.0, 0.05,
                                          0.2, jmlmc.MLMCConfig(4, 2, 4, 200_000), payoff="sum")
    assert abs(float(price) - float(ref)) < 4 * np.hypot(float(se), float(ref_se))


def test_mlmc_correction_means_shrink():
    cfg = MLMCConfig(num_levels=4, M_const=2, N0=4, M0=100_000)
    _, _, diag = mlmc_gbm_price(_gen(1), np.ones(3), 1.0, 1.0, 0.05, 0.2, cfg, payoff="mean")
    assert abs(diag[3]["mean"]) < abs(diag[1]["mean"]) + 1e-3


def test_mlmc_minibatch_coupling():
    (t_f, w_f), (t_c, w_c) = mlmc_minibatch(_gen(0), 4, 8, 2, T=1.0, factor=2)
    assert w_f.shape == (4, 9, 2) and w_c.shape == (4, 5, 2)
    np.testing.assert_allclose(w_c.numpy(), w_f[:, ::2, :].numpy(), rtol=1e-5, atol=1e-6)
    (jt_f, _), (jt_c, _) = jmlmc.mlmc_minibatch(jax.random.PRNGKey(0), 4, 8, 2, T=1.0)
    assert np.array_equal(t_f.numpy(), np.asarray(jt_f))
    assert np.array_equal(t_c.numpy(), np.asarray(jt_c))


def test_mlmc_with_correlation():
    C = generate_correlation_matrix(3, "restricted_random_correlation", seed=5)
    L = torch.from_numpy(cholesky_factor(C)).float()
    cfg = MLMCConfig(num_levels=4, M_const=2, N0=4, M0=150_000)
    price, se, _ = mlmc_gbm_price(_gen(2), np.ones(3), 1.0, 1.0, 0.05, 0.2, cfg, chol=L,
                                  payoff="mean")
    mc, mc_se = num.basket_call_mc(_gen(9), np.ones(3), 1.0, 1.0, 0.05, 0.2, chol=L,
                                   num_paths=300_000)
    assert abs(float(price) - float(mc)) < 4 * (float(se) + float(mc_se)) + 0.004


# ---------------------------------------------- correlation sensitivity/PCA
def _se_of_basket(S0, K, r, sigma, chol, n, seed=11):
    """The standard error of one scenario's n-path price (NumPy draw)."""
    z = np.random.default_rng(seed).standard_normal((200_000, len(S0))) @ chol.T
    pay = np.maximum(np.mean(S0 * np.exp((r - 0.5 * sigma**2) + sigma * z), axis=-1) - K, 0)
    return np.exp(-r) * pay.std() / np.sqrt(n)


def test_equicorrelation_matches_jax_and_is_monotone():
    rhos = [0.0, 0.3, 0.6, 0.9]
    ours = equicorrelation_sensitivity(np.ones(5), 1.0, 1.0, 0.05, 0.2, rhos,
                                       num_simulations=100_000, device=CPU)
    ref = jcorr.equicorrelation_sensitivity(np.ones(5), 1.0, 1.0, 0.05, 0.2, rhos,
                                            num_simulations=100_000)
    assert ours.shape == (4,) and (np.diff(ours) > 0).all()
    for rho, a, b in zip(rhos, ours, ref):
        C = np.full((5, 5), rho)
        np.fill_diagonal(C, 1.0)
        se = _se_of_basket(np.ones(5), 1.0, 0.05, 0.2, cholesky_factor(C), 100_000)
        assert abs(a - b) < 4 * np.sqrt(2) * se


def test_random_correlation_analysis_and_pca(tmp_path):
    an = RandomCorrelationSensitivityAnalysis(n=4, device=CPU)
    prices, mats = an.run_analysis("restricted_random_correlation", num_simulations=20_000,
                                   num_samples=20)
    ref_prices, ref_mats = jcorr.RandomCorrelationSensitivityAnalysis(n=4).run_analysis(
        "restricted_random_correlation", num_simulations=20_000, num_samples=20)
    assert prices.shape == (20,) and mats.shape == (20, 16)
    assert np.array_equal(mats, ref_mats)
    se = max(_se_of_basket(np.ones(4), 1.0, 0.05, 0.2, cholesky_factor(m.reshape(4, 4)),
                           20_000) for m in mats)
    assert np.abs(prices - ref_prices).max() < 4 * np.sqrt(2) * se
    comps, evr = an.pca_components(mats, n_components=2)
    assert comps.shape == (20, 2) and 0 < evr.sum() <= 1.0 + 1e-9
    path = an.plot_pca_results(prices, mats, str(tmp_path / "pca.png"))
    assert os.path.getsize(path) > 0


def test_no_correlation_prices_every_scenario_alike():
    prices, _ = RandomCorrelationSensitivityAnalysis(n=3, device=CPU).run_analysis(
        "no_correlation", 10_000, num_samples=5)
    assert np.allclose(prices, prices[0])
