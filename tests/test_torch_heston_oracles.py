"""The port's Heston oracles against the JAX package's, on the CPU: the
closed form and its surfaces (float32 on both sides, within 1e-5 relative),
the scipy-quad reference of ``test_numerics.py`` (2e-4, its bound), the two
Milstein pricers by statistics (their streams differ: within 4 combined
standard errors of JAX's, and within 4 SE + 5e-3 of the closed form, the
bound ``test_numerics.py`` gives the Milstein bias), Crank–Nicolson against
JAX's on a small grid (float32 on both sides, within 1e-4 of max|U|) and
against the closed form (1 %, ``test_numerics.py``'s bound), and
Gauss–Legendre quadrature."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from scipy import integrate

from dnnpde_tpu.numerics import CNGrid as JaxCNGrid
from dnnpde_tpu.numerics import HestonParams as JaxParams
from dnnpde_tpu.numerics import bilinear_interpolate as jax_bilinear
from dnnpde_tpu.numerics import cn_delta_gamma as jax_cn_delta_gamma
from dnnpde_tpu.numerics import crank_nicolson_heston as jax_cn
from dnnpde_tpu.numerics import gauss_legendre as jax_gauss_legendre
from dnnpde_tpu.numerics import heston_call_price as jax_price
from dnnpde_tpu.numerics import heston_delta_surface as jax_delta_surface
from dnnpde_tpu.numerics import heston_gamma_surface as jax_gamma_surface
from dnnpde_tpu.numerics import heston_mc_price as jax_mc
from dnnpde_tpu.numerics import heston_mc_price_ii as jax_mc_ii
from dnnpde_tpu.numerics import heston_price_surface as jax_price_surface
from dnnpde_tpu_torch.numerics import (
    CNGrid,
    HestonParams,
    bilinear_interpolate,
    cn_delta_gamma,
    crank_nicolson_heston,
    gauss_legendre,
    heston_call_price,
    heston_delta_surface,
    heston_gamma_surface,
    heston_mc_price,
    heston_mc_price_ii,
    heston_price_surface,
)
from test_numerics import _scipy_heston_price


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with several test workers on one host, PyTorch's
    default of one thread per core makes these small CPU ops many times
    slower (this file: ~20 s alone, up to ~13 min beside five workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF = HestonParams()
OFF = dict(K=1.1, r=0.03, T=2.0, kappa=1.5, theta=0.1, sigma=0.6, rho=-0.5, v0=0.15)
POINTS = [(1.0, 0.2), (0.8, 0.2), (1.2, 0.1), (1.0, 0.04)]


def _rel(a, ref, tol):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() <= tol * np.abs(ref).max()


def test_params_match_jax():
    assert HestonParams().__dict__ == JaxParams().__dict__
    assert CNGrid(S_max=2.0).__dict__ == JaxCNGrid(S_max=2.0).__dict__


@pytest.mark.parametrize("params", ["reference", "off"])
@pytest.mark.parametrize("compat", [False, True])
def test_closed_form_matches_jax(params, compat):
    kw = {} if params == "reference" else OFF
    ours_p, ref_p = HestonParams(**kw), JaxParams(**kw)
    for S, V in POINTS:
        got = heston_call_price(S, V, ours_p, order=512, reference_compat=compat, device="cpu")
        assert got.dtype == torch.float32
        ref = float(jax_price(S, V, ref_p, order=512, reference_compat=compat))
        assert abs(float(got) - ref) <= 1e-5 * abs(ref), (S, V)


def test_closed_form_matches_scipy_quad_and_reference_compat():
    for S, V in POINTS:
        ours = float(heston_call_price(S, V, REF, order=512, device="cpu"))
        assert ours == pytest.approx(_scipy_heston_price(S, V, JaxParams()), abs=2e-4), (S, V)
    correct = float(heston_call_price(1.0, 0.2, REF, order=512, device="cpu"))
    compat = float(heston_call_price(1.0, 0.2, REF, order=512, reference_compat=True,
                                     device="cpu"))
    assert compat == pytest.approx(0.169, abs=2e-3) and correct == pytest.approx(0.1984, abs=2e-3)


def test_closed_form_float64_and_broadcast():
    S = torch.tensor([0.8, 1.0, 1.2], dtype=torch.float64)
    got = heston_call_price(S, torch.full_like(S, 0.2), REF, order=512)
    assert got.dtype == torch.float64 and got.shape == (3,)
    for s, g in zip(S.tolist(), got.tolist()):
        assert g == pytest.approx(_scipy_heston_price(s, 0.2, JaxParams()), abs=2e-5)


def test_surfaces_match_jax():
    S_vals = np.linspace(0.6, 1.4, 9)
    V_vals = np.array([0.1, 0.2])
    for ours, ref in ((heston_price_surface, jax_price_surface),
                      (heston_delta_surface, jax_delta_surface),
                      (heston_gamma_surface, jax_gamma_surface)):
        got = ours(S_vals, V_vals, REF, order=128, device="cpu").numpy()
        want = np.asarray(ref(S_vals, V_vals, JaxParams(), order=128))
        assert got.shape == want.shape == (9, 2)
        # the difference stencils divide the price's f32 rounding by dS (and dS²)
        tol = {heston_price_surface: 1e-5, heston_delta_surface: 1e-4,
               heston_gamma_surface: 1e-2}[ours]
        _rel(got, want, tol)


@pytest.mark.parametrize("scheme", ["milstein", "ii"])
def test_monte_carlo_agrees_with_jax_and_the_closed_form_by_statistics(scheme):
    exact = float(heston_call_price(1.0, REF.v0, REF, order=512, device="cpu"))
    ours, theirs = (heston_mc_price, jax_mc) if scheme == "milstein" else (heston_mc_price_ii,
                                                                        jax_mc_ii)
    p, se = ours(torch.Generator().manual_seed(3), 1.0, REF, num_paths=60_000, num_steps=400)
    assert p.device.type == "cpu" and float(se) > 0
    jp, jse = theirs(jax.random.PRNGKey(3), 1.0, JaxParams(), num_paths=60_000, num_steps=400)
    p, se, jp, jse = float(p), float(se), float(jp), float(jse)
    assert abs(p - exact) < 4 * se + 5e-3
    assert abs(p - jp) < 4 * (se**2 + jse**2) ** 0.5
    # the payoff's spread, not its draws: at 60k paths the standard error
    # itself moves some 3 % from seed to seed on either side
    assert se == pytest.approx(jse, rel=0.1)


def test_monte_carlo_ii_off_equilibrium_v0():
    gen = torch.Generator().manual_seed(0)
    lo, _ = heston_mc_price_ii(gen, 1.0, REF, num_paths=30_000, num_steps=200, v0=0.05)
    hi, _ = heston_mc_price_ii(gen, 1.0, REF, num_paths=30_000, num_steps=200, v0=0.5)
    assert float(hi) > float(lo)  # vega > 0


def test_crank_nicolson_matches_jax_on_a_small_grid():
    grid = dict(S_max=2.0, v_max=0.5, n_S=20, n_v=10, n_t=50)
    price, U, S, v = crank_nicolson_heston(1.0, REF, CNGrid(**grid), device="cpu")
    jprice, jU, jS, jv = jax_cn(1.0, JaxParams(), JaxCNGrid(**grid))
    assert U.shape == (20, 10) and U.dtype == torch.float32
    _rel(U.numpy(), np.asarray(jU), 1e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-6)
    assert price == pytest.approx(jprice, rel=1e-4)
    for s0, v0 in ((1.0, 0.2), (0.73, 0.01), (1.9, 0.49)):
        got = float(bilinear_interpolate(U, S, v, s0, v0))
        assert got == pytest.approx(float(jax_bilinear(jU, jS, jv, s0, v0)), rel=1e-4, abs=1e-6)
    delta, gamma = cn_delta_gamma(U, S, v, 0.2)
    jdelta, jgamma = jax_cn_delta_gamma(jU, jS, jv, 0.2)
    _rel(delta.numpy(), np.asarray(jdelta), 1e-3)
    _rel(gamma.numpy(), np.asarray(jgamma), 1e-2)


def test_crank_nicolson_matches_the_closed_form():
    """The reference-style configuration of ``test_numerics.py`` (S0 = K =
    100, r = 0.03, 60 × 30 × 400) in float64: within 1 %."""
    p = HestonParams(K=100.0, r=0.03, T=1.0, kappa=2.0, theta=0.2, sigma=0.3, rho=0.8, v0=0.2)
    price, U, _, _ = crank_nicolson_heston(
        100.0, p, CNGrid(S_max=200.0, v_max=0.5, n_S=60, n_v=30, n_t=400),
        dtype=torch.float64, device="cpu")
    jp = JaxParams(K=100.0, r=0.03, T=1.0, kappa=2.0, theta=0.2, sigma=0.3, rho=0.8, v0=0.2)
    assert price == pytest.approx(_scipy_heston_price(100.0, 0.2, jp), rel=0.01)
    assert U.dtype == torch.float64 and bool(torch.isfinite(U).all())


def test_gauss_legendre_matches_jax_and_scipy():
    f = lambda x: np.exp(-x) * np.cos(3 * x)  # noqa: E731
    exact, _ = integrate.quad(f, 0.0, 5.0)
    got = float(gauss_legendre(lambda x: torch.exp(-x) * torch.cos(3 * x), 0.0, 5.0, order=64,
                               dtype=torch.float64, device="cpu"))
    assert got == pytest.approx(exact, rel=1e-12)
    f32 = gauss_legendre(lambda x: torch.exp(-x) * torch.cos(3 * x), 0.0, 5.0, order=64,
                         device="cpu")
    ref = float(jax_gauss_legendre(lambda x: jax.numpy.exp(-x) * jax.numpy.cos(3 * x), 0.0, 5.0,
                                   order=64))
    assert f32.dtype == torch.float32 and float(f32) == pytest.approx(ref, rel=1e-5)
