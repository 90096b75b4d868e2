"""Heston stochastic-volatility PDE problem, the counterpart of
``dnnpde_tpu/pde/heston.py``.

2-factor state X = (S, v): CIR variance drift and a full 2×2 diffusion,

  mu    = [r·S, κ(θ − v)]                 (clipped to ±clamp_bound)
  sigma = the Cholesky factor of the Heston covariance (default), or the
          reference's matrix, which is not a factor of it (``diffusion``)
  phi   = r·Y
  g     = max(S − K, 0), or the sigmoid-smoothed z·sigmoid(αz)

The net takes (t, S, v), Z = (∂u/∂S, ∂u/∂v), and the terminal gradient
penalty applies to Z_S only (``z_penalty_mask``). The output
parametrization (``transform_u``) is selected by ``clamp_output`` and
``clamp_smoothing``:

- "bs" (default): the Black–Scholes control-variate head
  u = BS(S, K, τ, √v) + √(τ/T)·raw — exact at τ = 0, no clamp (``clamp_u``
  is None, so no u ≡ 0 absorbing state for the collapse check);
- "hard": max(u, 0), the reference's clamp;
- "softplus": softplus(β·u)/β;
- "anchor": the intrinsic floor max(S − K·e^{−rτ}, 0) plus
  √(τ/T)·softplus(raw + anchor_shift) (``anchor_time_scale="sqrt"``);
- ``clamp_output=False``: the plain output.

The JAX module's docstrings give the measured trade-offs of each mode.
:class:`HestonAmericanPut` is the American (Bermudan-N) put under the same
dynamics; it needs the local objective.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from dnnpde_tpu_torch.numerics.black_scholes import black_scholes_call
from dnnpde_tpu_torch.pde.base import PDEProblem, Tensor


@dataclasses.dataclass(frozen=True)
class HestonPDE(PDEProblem):
    """Heston FBSNN problem (reference defaults κ=2, θ=0.2, σ_v=0.3, ρ=0.8,
    v0=0.2, r=0.05, strike K=1.0, S0=1.0)."""

    S0: float = 1.0
    v0: float = 0.2
    r: float = 0.05
    kappa: float = 2.0
    theta: float = 0.2
    sigma_v: float = 0.3
    rho: float = 0.8
    strike: float = 1.0
    payoff_type: str = "discontinuous"  # or "continuous" (sigmoid-smoothed)
    smoothing_alpha: float = 10.0
    clamp_bound: float = 100.0
    clamp_output: bool = True
    clamp_smoothing: str = "bs"  # "hard" | "softplus" | "anchor" | "bs"
    bs_cdf: str = "tanh"  # Φ inside the "bs" head: "tanh" (≈3e-4) | "erf" (exact)
    smooth_beta: float = 50.0
    anchor_shift: float = -2.0  # softplus(−2) ≈ 0.127: the anchor head's scale at a zero net
    anchor_time_scale: str = "sqrt"  # "sqrt" | "none"
    diffusion: str = "cholesky"  # "cholesky" | "reference"
    name: str = "Heston"

    @property
    def dim(self) -> int:
        return 2

    @property
    def sigma_kind(self) -> str:
        return "full"

    @property
    def clamp_u(self) -> Optional[float]:
        # the "bs" head is a control variate, not a clamp: u ≈ 0 is no
        # absorbing state there
        if self.clamp_output and self.clamp_smoothing != "bs":
            return 0.0
        return None

    @property
    def has_output_transform(self) -> bool:
        return self.clamp_output

    @property
    def clamp_mode(self) -> str:
        return self.clamp_smoothing

    @property
    def clamp_beta(self) -> float:
        return self.smooth_beta

    def intrinsic_floor(self, t: Tensor, X: Tensor) -> Tensor:
        """European-call lower bound max(S − K·e^{−r(T−t)}, 0), (M, 1)."""
        S = X[..., 0:1]
        return torch.clamp(S - self.strike * torch.exp(-self.r * (self.T - t)), min=0.0)

    def transform_u(self, t: Tensor, X: Tensor, u: Tensor) -> Tensor:
        if not self.clamp_output or self.clamp_smoothing not in ("anchor", "bs"):
            return super().transform_u(t, X, u)
        if self.clamp_smoothing == "bs":
            S, v = X[..., 0:1], X[..., 1:2]
            tau = torch.clamp(self.T - t, min=0.0)
            sig = torch.sqrt(torch.clamp(v, min=1e-8))
            base = black_scholes_call(S, self.strike, tau, self.r, sig, cdf=self.bs_cdf)
            return base + torch.sqrt(tau / self.T) * u
        head = F.softplus(u + self.anchor_shift)
        if self.anchor_time_scale == "sqrt":
            head = torch.sqrt(torch.clamp((self.T - t) / self.T, min=0.0)) * head
        return self.intrinsic_floor(t, X) + head

    @property
    def z_penalty_mask(self) -> Optional[Tensor]:
        return torch.tensor([1.0, 0.0], dtype=torch.float32)

    @property
    def x0(self) -> Tensor:
        return torch.tensor([self.S0, self.v0], dtype=torch.float32)

    def mu(self, t, X, Y, Z):
        S, v = X[..., 0:1], X[..., 1:2]
        out = torch.cat([self.r * S, self.kappa * (self.theta - v)], dim=-1)
        return torch.clamp(out, -self.clamp_bound, self.clamp_bound)

    def sigma(self, t, X, Y):
        S, v = X[..., 0], X[..., 1]
        sqrt_v = torch.sqrt(torch.clamp(v, min=1e-8))
        sig_s = sqrt_v * S
        sig_v = self.sigma_v * sqrt_v
        if self.diffusion == "cholesky":
            # L·Lᵀ = [[vS², ρσ_v vS], [ρσ_v vS, σ_v² v]]: the Heston covariance
            row0 = torch.stack([sig_s, torch.zeros_like(sig_s)], dim=-1)
            row1 = torch.stack([self.rho * sig_v, math.sqrt(1.0 - self.rho**2) * sig_v], dim=-1)
        elif self.diffusion == "reference":
            row0 = torch.stack([sig_s, self.rho * sig_v], dim=-1)
            row1 = torch.stack([self.rho * sig_s, sig_v], dim=-1)
        else:
            raise ValueError(
                f"diffusion must be 'cholesky' or 'reference', got {self.diffusion!r}"
            )
        out = torch.stack([row0, row1], dim=-2)  # (M, 2, 2)
        return torch.clamp(out, -self.clamp_bound, self.clamp_bound)

    def phi(self, t, X, Y, Z):
        return self.r * Y

    def g(self, X):
        S = X[..., 0:1]
        if self.payoff_type == "discontinuous":
            return torch.clamp(S - self.strike, min=0.0)
        if self.payoff_type == "continuous":
            z = S - self.strike  # z·sigmoid(αz): stable where z/(1 + e^{−αz}) overflows
            return z * torch.sigmoid(self.smoothing_alpha * z)
        raise ValueError("Invalid payoff_type; choose 'discontinuous' or 'continuous'.")


@dataclasses.dataclass(frozen=True)
class HestonAmericanPut(HestonPDE):
    """American (Bermudan-N) put under Heston dynamics: optimal stopping
    with stochastic volatility. No binomial tree exists for it; its oracle
    is ``numerics.lsmc_value`` on the solver's own Euler chain.

    Inherits the Cholesky diffusion and the "bs" machinery of
    :class:`HestonPDE`, with the payoff a put and the head the BS put by
    put–call parity on the same call,

        u_cont = BS_put(S, K, τ, √v) + √(τ/T)·raw,

    exact at τ = 0 (the net learns the stochastic-vol correction and the
    early-exercise premium, of either sign). Only the "bs" head and the
    plain output (``clamp_output=False``) are allowed. Requires
    ``Trainer(objective="local")``; the served value is ``max(g, u)``
    (:meth:`PDEProblem.value_u`).
    """

    name: str = "HestonAmericanPut"

    @property
    def early_exercise(self) -> bool:
        return True

    def g(self, X):
        S = X[..., 0:1]
        return torch.clamp(self.strike - S, min=0.0)

    def transform_u(self, t: Tensor, X: Tensor, u: Tensor) -> Tensor:
        if not self.clamp_output or self.clamp_smoothing != "bs":
            if self.clamp_output:
                raise ValueError(
                    "HestonAmericanPut supports clamp_output=False (plain) or the default bs "
                    "head only"
                )
            return u
        S, v = X[..., 0:1], X[..., 1:2]
        tau = torch.clamp(self.T - t, min=0.0)
        sig = torch.sqrt(torch.clamp(v, min=1e-8))
        call = black_scholes_call(S, self.strike, tau, self.r, sig, cdf=self.bs_cdf)
        put = call - S + self.strike * torch.exp(-self.r * tau)
        return put + torch.sqrt(tau / self.T) * u
