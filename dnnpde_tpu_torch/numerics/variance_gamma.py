"""Variance-Gamma basket option pricer, the counterpart of
``dnnpde_tpu/numerics/variance_gamma.py``.

The basket spot B0 = Σ wᵢS⁰ᵢ is driven by a VG process (σ, ν, θ) with the
martingale correction ω = ν⁻¹·ln(1 − θν − ½σ²ν), and

  C = B0 − K·e^{−rT}·(½ + π⁻¹ ∫₀^∞ Re[e^{−iu ln K}·φ(u)/(iu)] du),
  φ(u) = exp(iu(ln B0 + (r+ω)T)) / |1 − iθνu + ½σ²νu²|^{T/ν}

(the reference's formulation, its |·| in the denominator and its [0, 1000]
truncation included), integrated by a 2048-point Gauss–Legendre rule in
float32/complex64 on the device, as the JAX package integrates it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from dnnpde_tpu_torch.numerics.quadrature import gauss_legendre
from dnnpde_tpu_torch.runtime import default_device


@dataclasses.dataclass(frozen=True)
class VGParams:
    """VG process parameters (reference Table-2 values: σ=0.57, ν=0.75, θ=−0.95)."""

    sigma: float = 0.57
    nu: float = 0.75
    theta: float = -0.95


def vg_basket_call(S0_weights: Sequence[Tuple[float, float]], K: float, T: float, r: float,
                   vg: VGParams = VGParams(), order: int = 2048, u_max: float = 1000.0,
                   device=None) -> float:
    """VG basket call price. ``device``: None = the first CUDA card (raises
    without one); "cpu" integrates on the CPU."""
    dev = default_device(device)
    B0 = float(sum(s0 * w for s0, w in S0_weights))
    omega = (1.0 / vg.nu) * np.log(max(1e-10, 1.0 - vg.theta * vg.nu - 0.5 * vg.sigma**2 * vg.nu))
    log_b0 = torch.log(torch.tensor(B0, dtype=torch.float32, device=dev))
    log_k = torch.log(torch.tensor(K, dtype=torch.float32, device=dev))

    def integrand(u):
        expo = 1j * u * (log_b0 + (r + omega) * T)
        denom = torch.pow(
            torch.abs(1.0 - 1j * vg.theta * vg.nu * u + 0.5 * vg.sigma**2 * vg.nu * u**2),
            T / vg.nu)
        return torch.real(torch.exp(-1j * u * log_k) * (torch.exp(expo) / denom) / (1j * u))

    # start slightly above the u = 0 singularity, like quad's open rule
    integral = float(gauss_legendre(integrand, 1e-8, u_max, order, device=dev))
    return max(B0 - K * np.exp(-r * T) * (0.5 + integral / np.pi), 0.0)


def vg_table_2(device=None) -> List[Tuple[float, float]]:
    """The reference's Table 2: basket S0 = (40, 50, 60), w = 1/3,
    K ∈ {50, 55, 60}, T = 1, r = 0.05, VG (0.57, 0.75, −0.95)."""
    S0w = [(40.0, 1 / 3), (50.0, 1 / 3), (60.0, 1 / 3)]
    vg = VGParams(0.57, 0.75, -0.95)
    return [(K, vg_basket_call(S0w, K, 1.0, 0.05, vg, device=device)) for K in (50.0, 55.0, 60.0)]


def vg_table_3(device=None) -> List[Tuple[float, float, float]]:
    """The reference's Table 3: basket S0 = (100, 100), w = ½, K = 105.13,
    VG (0.3477, 0.4932, −0.3919); one price reported at σ ∈ {0.2, 0.4}."""
    S0w = [(100.0, 0.5), (100.0, 0.5)]
    price = vg_basket_call(S0w, 105.13, 1.0, 0.05, VGParams(0.3477, 0.4932, -0.3919),
                           device=device)
    return [(sig, 0.5, price) for sig in (0.2, 0.4)]
