"""Black–Scholes closed forms, the counterpart of
``dnnpde_tpu/numerics/black_scholes.py``.

Φ is ``torch.special.ndtr``. Tensor arguments stay on their device unless
``device`` names another; Python numbers and numpy arrays are computed in
float32 on ``device`` (None → the first CUDA card, which raises without one
unless ``device="cpu"``).
"""

from __future__ import annotations

import torch

from dnnpde_tpu_torch.runtime import device_of

Tensor = torch.Tensor

_TANH_C = 0.7978845608028654  # √(2/π)


def _f32(x, device) -> Tensor:
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=x.dtype if x.is_floating_point() else torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _cdf_tanh(x: Tensor) -> Tensor:
    """Smooth Φ(x) approximation 0.5(1 + tanh(√(2/π)(x + 0.044715x³)))
    (the GELU tanh form; max |Φ̂ − Φ| ≈ 3e-4)."""
    return 0.5 * (1.0 + torch.tanh(_TANH_C * (x + 0.044715 * x**3)))


def black_scholes_call(
    S, K: float, T, r: float, sigma: float, q: float = 0.0, cdf: str = "erf",
    device=None,
) -> Tensor:
    """European call price, broadcast over S and T (time to maturity).

    T ≤ 1e-12 gives the intrinsic value max(S − K, 0). ``cdf``: "erf" (the
    exact Φ, the oracle default) or "tanh" (the smooth ≈3e-4 approximation).
    """
    dev = device_of(S, T, device=device)
    S, T = _f32(S, dev), _f32(T, dev)
    eps = 1e-12
    Tc = torch.clamp(T, min=eps)
    sqrtT = torch.sqrt(Tc)
    d1 = (torch.log(torch.clamp(S, min=eps) / K) + (r - q + 0.5 * sigma**2) * Tc) / (
        sigma * sqrtT
    )
    d2 = d1 - sigma * sqrtT
    Phi = _cdf_tanh if cdf == "tanh" else torch.special.ndtr
    price = S * torch.exp(-q * Tc) * Phi(d1) - K * torch.exp(-r * Tc) * Phi(d2)
    intrinsic = torch.clamp(S - K, min=0.0)
    return torch.where(T <= eps, intrinsic, price)


def black_scholes_delta(
    S, K: float, T, r: float, sigma: float, q: float = 0.0, device=None
) -> Tensor:
    """Call delta ∂C/∂S; at T ≤ 1e-12 the step 1{S > K}."""
    dev = device_of(S, T, device=device)
    S, T = _f32(S, dev), _f32(T, dev)
    eps = 1e-12
    Tc = torch.clamp(T, min=eps)
    d1 = (torch.log(torch.clamp(S, min=eps) / K) + (r - q + 0.5 * sigma**2) * Tc) / (
        sigma * torch.sqrt(Tc)
    )
    return torch.where(T <= eps, (S > K).to(S.dtype), torch.exp(-q * Tc) * torch.special.ndtr(d1))


def call_price_grid(
    X_paths, t_grid, K: float, T: float, r: float, sigma: float, device=None
) -> tuple[Tensor, Tensor]:
    """Exact call price and delta at every (path, step) of a path array.

    Args:
      X_paths: (M, N+1) spot levels (for baskets, the aggregated level).
      t_grid: (N+1,) or (M, N+1) times.
    Returns: (prices, deltas), each (M, N+1).
    """
    dev = device_of(X_paths, t_grid, device=device)
    tau = T - _f32(t_grid, dev)
    X_paths = _f32(X_paths, dev)
    return (
        black_scholes_call(X_paths, K, tau, r, sigma),
        black_scholes_delta(X_paths, K, tau, r, sigma),
    )


def basket_analytical_approx(
    S0, K: float, T: float, r: float, sigma: float, D: int, device=None
) -> Tensor:
    """Basket ≈ one lognormal with σ_avg = σ/√D on the mean spot."""
    dev = device_of(S0, device=device)
    mean_spot = torch.mean(_f32(S0, dev))
    return black_scholes_call(mean_spot, K, _f32(T, dev), r, sigma / D**0.5)


def geometric_asian_call(
    S0: float, K: float, T: float, r: float, sigma: float, N: int, device=None
) -> float:
    """Discretely-sampled geometric-average Asian call, exact under GBM
    (Kemna–Vorst, discrete form). With sampling dates t_i = i·T/N,
    i = 1..N, G = (Π S_{t_i})^{1/N} is lognormal with

        E[log G]   = log S0 + (r − σ²/2)·T(N+1)/(2N)
        Var[log G] = σ²·T·(N+1)(2N+1)/(6N²)

    and the price is e^{−rT}(e^{μ+v/2}Φ(d1) − KΦ(d2))."""
    dev = device_of(device=device)
    mu = torch.log(_f32(S0, dev)) + (r - 0.5 * sigma**2) * T * (N + 1) / (2 * N)
    v = _f32(sigma**2 * T * (N + 1) * (2 * N + 1) / (6 * N**2), dev)
    s = torch.sqrt(v)
    d1 = (mu - torch.log(_f32(K, dev)) + v) / s
    d2 = d1 - s
    ndtr = torch.special.ndtr
    disc = torch.exp(_f32(-r * T, dev))
    return float(disc * (torch.exp(mu + 0.5 * v) * ndtr(d1) - K * ndtr(d2)))


def lookback_call_floating(
    S0: float, T: float, r: float, sigma: float, device=None
) -> float:
    """Continuously-monitored floating-strike lookback call
    E[e^{−rT}(S_T − min_{t≤T} S_t)] under GBM for a fresh contract
    (Goldman–Sosin–Gatto). With a1 = (r + σ²/2)√T/σ and a2 = a1 − σ√T:

        C = S0[Φ(a1) − e^{−rT}Φ(a2)] + S0·(σ²/2r)·[e^{−rT}Φ(a2) − Φ(−a1)]

    An upper bound for the discretely-monitored contract."""
    dev = device_of(device=device)
    sqT = torch.sqrt(_f32(T, dev))
    a1 = (r + 0.5 * sigma**2) * sqT / sigma
    a2 = a1 - sigma * sqT
    ndtr = torch.special.ndtr
    disc = torch.exp(_f32(-r * T, dev))
    c = S0 * (ndtr(a1) - disc * ndtr(a2)) + S0 * (sigma**2 / (2.0 * r)) * (
        disc * ndtr(a2) - ndtr(-a1)
    )
    return float(c)


def bsb_exact_solution(
    t, X, T: float, r: float = 0.05, sigma_bar: float = 0.4, device=None
) -> Tensor:
    """Black–Scholes–Barenblatt closed form u = exp((r+σ̄²)(T−t))·ΣX².
    X: (..., D); t broadcastable."""
    dev = device_of(X, t, device=device)
    X, t = _f32(X, dev), _f32(t, dev)
    return torch.exp((r + sigma_bar**2) * (T - t)) * torch.sum(X**2, dim=-1, keepdim=True)
