"""Carr–Madan FFT basket pricer, the counterpart of
``dnnpde_tpu/numerics/fft_pricer.py``.

The basket is priced as one lognormal underlier whose volatility is the
exact two-moment match (host-side float64), with the damped Carr–Madan
transform (α = 1.5, 2¹² points, Simpson weights) computed by ``torch.fft``
in complex64 on the device and linearly interpolated to the strike, as the
JAX package computes it in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from dnnpde_tpu_torch.runtime import default_device


def basket_lognormal_cf_params(S0, sigma, corr: Optional[np.ndarray],
                               weights: Optional[np.ndarray] = None,
                               T: float = 1.0) -> tuple[float, float]:
    """The lognormal proxy of the basket, (B0, σ_B): B0 = wᵀS⁰ and
    σ_B² = ln(m₂/m₁²)/T with m₂ = Σᵢⱼ wᵢwⱼS⁰ᵢS⁰ⱼe^{σᵢσⱼρᵢⱼT}."""
    S0 = np.atleast_1d(np.asarray(S0, dtype=np.float64))
    D = S0.shape[0]
    w = np.full(D, 1.0 / D) if weights is None else np.asarray(weights, np.float64)
    sig = np.broadcast_to(np.asarray(sigma, np.float64), (D,))
    C = np.eye(D) if corr is None else np.asarray(corr, np.float64)
    B0 = float(w @ S0)
    wS = w * S0
    m1 = wS.sum()
    m2 = float(np.einsum("i,j,ij->", wS, wS, np.exp(np.outer(sig, sig) * C * T)))
    return B0, float(np.sqrt(max(np.log(m2 / m1**2), 1e-12) / T))


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``np.interp`` for an increasing grid ``xp``: linear inside, the end
    values outside."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    y = f0 + (x - x0) * (f1 - f0) / (x1 - x0)
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], y))


def carr_madan_call(B0: float, K: float, T: float, r: float, sigma_B: float,
                    alpha: float = 1.5, n_fft: int = 4096, eta: float = 0.25,
                    device=None) -> float:
    """Damped-FFT call price for a lognormal underlier. ``device``: None =
    the first CUDA card (raises without one); "cpu" computes on the CPU."""
    dev = default_device(device)
    n = torch.arange(n_fft, dtype=torch.float32, device=dev)
    u = n * eta
    mu = math.log(B0) + (r - 0.5 * sigma_B**2) * T

    def cf(v):
        return torch.exp(1j * v * mu - 0.5 * v**2 * sigma_B**2 * T)

    v = u.to(torch.complex64) - (alpha + 1) * 1j
    psi = math.exp(-r * T) * cf(v) / (alpha**2 + alpha - u**2 + 1j * (2 * alpha + 1) * u)
    lam = 2 * math.pi / (n_fft * eta)
    b = 0.5 * n_fft * lam
    simpson = (3.0 - (-1.0) ** n) / 3.0  # 1/3, 4/3, 2/3, ... after the first
    simpson[0] = 1.0 / 3.0
    x = torch.exp(1j * b * u) * psi * eta * simpson
    ks = -b + lam * n  # the log-strike grid
    calls = torch.exp(-alpha * ks) / math.pi * torch.real(torch.fft.fft(x))
    log_k = torch.tensor([math.log(K)], dtype=torch.float32, device=dev)
    return float(_interp(log_k, ks, calls)[0])


def fft_basket_call(S0, K: float, T: float, r: float, sigma, corr: Optional[np.ndarray] = None,
                    weights: Optional[np.ndarray] = None, alpha: float = 1.5,
                    n_fft: int = 4096, device=None) -> float:
    """The basket call by the lognormal proxy and the Carr–Madan FFT."""
    B0, sigma_B = basket_lognormal_cf_params(S0, sigma, corr, weights, T)
    return carr_madan_call(B0, K, T, r, sigma_B, alpha, n_fft, device=device)
