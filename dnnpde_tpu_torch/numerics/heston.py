"""Heston model oracles, the counterpart of ``dnnpde_tpu/numerics/heston.py``:
the closed form (characteristic function, Heston 1993 P1/P2 integrated on
[0, 100] by a fixed-order Gauss–Legendre rule), its price/delta/gamma
surfaces, and two independent Milstein Monte-Carlo pricers.

The closed form computes in the dtype of its input (Python numbers:
float32, complex64 inside, as the JAX package computes without x64) on the
input's device (Python numbers: ``device``, None → the first CUDA card). It
broadcasts over S and V, so a surface is one call. The Monte-Carlo pricers
draw from an explicit ``torch.Generator`` and run on its device; their
streams differ from the JAX package's, so they agree with it in
distribution, not draw by draw.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from dnnpde_tpu_torch.numerics.black_scholes import _f32
from dnnpde_tpu_torch.numerics.quadrature import gauss_legendre
from dnnpde_tpu_torch.runtime import device_of

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HestonParams:
    """Reference defaults: κ=2, θ=0.2, σ=0.3, ρ=0.8, v0=0.2, r=0.05, K=1, T=1."""

    K: float = 1.0
    r: float = 0.05
    T: float = 1.0
    kappa: float = 2.0
    theta: float = 0.2
    sigma: float = 0.3
    rho: float = 0.8
    v0: float = 0.2
    lam: float = 0.0  # market price of vol risk (the reference fixes λ = 0)


def _char_func(p: HestonParams, phi: Tensor, S: Tensor, V: Tensor, which: int) -> Tensor:
    """Heston characteristic function f_j (j = 1, 2) in the trap-free
    (Albrecher et al. 2007) rotation: g2 = 1/g and e^{−dT}, so every factor
    stays bounded at any maturity; the same function as Heston 1993's."""
    a = p.kappa * p.theta
    if which == 1:
        u = 0.5
        b = p.kappa + p.lam - p.rho * p.sigma
    else:
        u = -0.5
        b = p.kappa + p.lam
    rspi = p.rho * p.sigma * 1j * phi
    d = torch.sqrt((rspi - b) ** 2 - p.sigma**2 * (2 * u * 1j * phi - phi**2))
    g2 = (b - rspi - d) / (b - rspi + d)
    exp_mdT = torch.exp(-d * p.T)
    ge = g2 * exp_mdT
    # guard the removable singularities ge → 1 and g2 → 1 (d → 0)
    ge = torch.where(torch.abs(ge - 1.0) < 1e-8, torch.full_like(ge, 1e-8), ge)
    g2 = torch.where(torch.abs(g2 - 1.0) < 1e-8, torch.full_like(g2, 1e-8), g2)
    C = p.r * 1j * phi * p.T + (a / p.sigma**2) * (
        (b - rspi - d) * p.T - 2.0 * torch.log((1.0 - ge) / (1.0 - g2))
    )
    Dv = ((b - rspi - d) / p.sigma**2) * ((1.0 - exp_mdT) / (1.0 - ge))
    S_safe = torch.clamp(S, min=1e-8)
    return torch.exp(C + Dv * V + 1j * phi * torch.log(S_safe))


def _prob(p: HestonParams, S: Tensor, V: Tensor, which: int, order: int) -> Tensor:
    """P_j = 1/2 + (1/π)∫₀^∞ Re[e^{−iφ ln K} f_j(φ)/(iφ)] dφ, truncated at 100,
    broadcast over S and V (the nodes ride a new last axis)."""
    S_, V_ = S[..., None], V[..., None]
    log_k = torch.log(torch.tensor(p.K, dtype=S.dtype, device=S.device))

    def integrand(phi):
        f = _char_func(p, phi, S_, V_, which)
        return torch.real(torch.exp(-1j * phi * log_k) * f / (1j * phi + 1e-10))

    integral = gauss_legendre(integrand, 0.0, 100.0, order, dtype=S.dtype, device=S.device)
    return 0.5 + integral / math.pi


def heston_call_price(
    S, V, params: HestonParams = HestonParams(), order: int = 256,
    reference_compat: bool = False, device=None,
) -> Tensor:
    """European call under Heston: S·P1 − K·e^{−rT}·P2, broadcast over S
    and V.

    The reference assembles e^{−rT}·(S·P1 − K·P2), discounting S·P1 too,
    which is wrong (P1 is the exercise probability under the stock
    numeraire): 0.169 where both Milstein pricers converge to 0.198 at the
    reference's parameters. ``reference_compat=True`` gives its number."""
    dev = device_of(S, V, device=device)
    S = _f32(S, dev)
    V = _f32(V, dev).to(S.dtype)
    p1 = _prob(params, S, V, 1, order)
    p2 = _prob(params, S, V, 2, order)
    disc = math.exp(-params.r * params.T)
    if reference_compat:
        return disc * (S * p1 - params.K * p2)
    return S * p1 - params.K * disc * p2


def heston_price_surface(
    S_values, V_values, params: HestonParams = HestonParams(), order: int = 256, device=None,
) -> Tensor:
    """(len(S), len(V)) price grid, in one broadcast call."""
    dev = device_of(S_values, V_values, device=device)
    S = _f32(S_values, dev).reshape(-1, 1)
    V = _f32(V_values, dev).reshape(1, -1).to(S.dtype)
    return heston_call_price(S, V, params, order)


def heston_delta_surface(
    S_values, V_values, params: HestonParams = HestonParams(), order: int = 256, device=None,
) -> Tensor:
    """∂Price/∂S by forward difference over the S grid; the last S row is
    zero, as in the reference's stencil."""
    grid = heston_price_surface(S_values, V_values, params, order, device)
    dS = float(S_values[1] - S_values[0])
    d = (grid[1:, :] - grid[:-1, :]) / dS
    return torch.cat([d, torch.zeros_like(grid[:1, :])], dim=0)


def heston_gamma_surface(
    S_values, V_values, params: HestonParams = HestonParams(), order: int = 256, device=None,
) -> Tensor:
    """∂²Price/∂S² by central second difference; first and last rows zero."""
    grid = heston_price_surface(S_values, V_values, params, order, device)
    dS = float(S_values[1] - S_values[0])
    g = (grid[2:, :] - 2 * grid[1:-1, :] + grid[:-2, :]) / (dS**2)
    zero = torch.zeros_like(grid[:1, :])
    return torch.cat([zero, g, zero], dim=0)


def _price_and_se(logS_T: Tensor, params: HestonParams) -> tuple[Tensor, Tensor]:
    payoff = torch.clamp(torch.exp(logS_T) - params.K, min=0.0)
    disc = math.exp(-params.r * params.T)
    n = payoff.shape[0]
    return disc * payoff.mean(), disc * payoff.std(correction=0) / math.sqrt(n)


def heston_mc_price(
    generator: torch.Generator, S0: float, params: HestonParams = HestonParams(),
    num_paths: int = 100_000, num_steps: int = 1000,
) -> tuple[Tensor, Tensor]:
    """Milstein Monte-Carlo call price, (price, standard_error), on the
    generator's device. Variance: Milstein step with the ¼σ²Δt(Z²−1)
    correction, reflected at 0; stock: log-Euler with the variance shock
    correlated from the stock shock. Each step draws its two normals."""
    dev = generator.device
    dt = params.T / num_steps
    sqrt_dt = math.sqrt(dt)
    rho_c = math.sqrt(1 - params.rho**2)
    logS = torch.full((num_paths,), math.log(S0), device=dev)
    v = torch.full((num_paths,), params.v0, device=dev)
    for _ in range(num_steps):
        z_s = torch.randn(num_paths, generator=generator, device=dev)
        z_v = params.rho * z_s + rho_c * torch.randn(num_paths, generator=generator, device=dev)
        v_pos = torch.clamp(v, min=0.0)
        sqrt_v = torch.sqrt(v_pos)
        v_next = (v + params.kappa * (params.theta - v_pos) * dt
                  + params.sigma * sqrt_v * sqrt_dt * z_v
                  + 0.25 * params.sigma**2 * dt * (z_v**2 - 1.0))
        logS = logS + (params.r - 0.5 * v_pos) * dt + sqrt_v * sqrt_dt * z_s
        v = torch.abs(v_next)  # reflection
    return _price_and_se(logS, params)


def heston_mc_price_ii(
    generator: torch.Generator, S0: float, params: HestonParams = HestonParams(),
    num_paths: int = 100_000, num_steps: int = 1000, v0: float | None = None,
) -> tuple[Tensor, Tensor]:
    """The second, independent Heston Monte Carlo (the reference's scheme
    II), (price, standard_error): negative variance truncated, v ← max(v, 0),
    instead of reflected, and the stock shock built from the variance
    shock. ``v0`` starts the variance off its equilibrium (for surfaces)."""
    dev = generator.device
    dt = params.T / num_steps
    sqrt_dt = math.sqrt(dt)
    rho_c = math.sqrt(1 - params.rho**2)
    logS = torch.full((num_paths,), math.log(S0), device=dev)
    v = torch.full((num_paths,), params.v0 if v0 is None else v0, device=dev)
    for _ in range(num_steps):
        z_v = torch.randn(num_paths, generator=generator, device=dev)
        z_s = params.rho * z_v + rho_c * torch.randn(num_paths, generator=generator, device=dev)
        sqrt_v = torch.sqrt(v)
        v_next = (v + params.kappa * (params.theta - v) * dt
                  + params.sigma * sqrt_v * sqrt_dt * z_v
                  + 0.25 * params.sigma**2 * dt * (z_v**2 - 1.0))
        logS = logS + (params.r - 0.5 * v) * dt + sqrt_v * sqrt_dt * z_s
        v = torch.clamp(v_next, min=0.0)  # truncation
    return _price_and_se(logS, params)
