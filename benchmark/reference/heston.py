"""The Heston call (state X = (S, v)) at the parameters of the original
``heston_dnnpde.py:519-699``: κ = 2, θ = 0.2, σ_v = 0.3, ρ = 0.8, v0 = 0.2,
r = 0.05, K = 1, S0 = 1, T = 1, with the Cholesky diffusion and the
Black–Scholes output head that ``HestonPDE()`` uses by default.

  μ = [r S, κ(θ − v)],  σ = the Cholesky factor of the Heston covariance
  [[v S², ρ σ_v v S], [ρ σ_v v S, σ_v² v]], both clipped to ±100;
  φ = r Y,  g = max(S − K, 0),  the terminal Z penalty on Z_S only;
  u = BS(S, K, τ, √v) + √(τ/T)·net (the Black–Scholes control-variate head,
  Φ the smooth 0.5(1 + tanh(√(2/π)(x + 0.044715 x³))), exact at τ = 0).
"""

from __future__ import annotations

import dataclasses
import math

import torch

Tensor = torch.Tensor
_CLAMP = 100.0


def _cdf(x: Tensor) -> Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


@dataclasses.dataclass(frozen=True)
class Problem:
    S0: float = 1.0
    v0: float = 0.2
    r: float = 0.05
    kappa: float = 2.0
    theta: float = 0.2
    sigma_v: float = 0.3
    rho: float = 0.8
    strike: float = 1.0
    T: float = 1.0

    dim = 2
    gbm = None

    def x0(self, device) -> Tensor:
        return torch.tensor([self.S0, self.v0], dtype=torch.float32, device=device)

    def drift(self, t, X, Y, Z):
        S, v = X[:, 0:1], X[:, 1:2]
        return torch.clamp(torch.cat([self.r * S, self.kappa * (self.theta - v)], dim=-1),
                           -_CLAMP, _CLAMP)

    def diffuse(self, t, X, Y, dW):
        """σ(X) ΔW with σ the clipped Cholesky factor."""
        S, v = X[:, 0], X[:, 1]
        sq = torch.sqrt(torch.clamp(v, min=1e-8))
        s_s, s_v = sq * S, self.sigma_v * sq
        c = lambda a: torch.clamp(a, -_CLAMP, _CLAMP)  # noqa: E731
        d0 = c(s_s) * dW[:, 0] + c(torch.zeros_like(s_s)) * dW[:, 1]
        d1 = c(self.rho * s_v) * dW[:, 0] + c(math.sqrt(1.0 - self.rho**2) * s_v) * dW[:, 1]
        return torch.stack([d0, d1], dim=-1)

    def phi(self, t, X, Y, Z):
        return self.r * Y

    def g(self, X):
        return torch.clamp(X[:, 0:1] - self.strike, min=0.0)

    def dg(self, X):
        return torch.cat([(X[:, 0:1] > self.strike).float(), torch.zeros_like(X[:, 1:2])], -1)

    @property
    def z_mask(self):
        return (1.0, 0.0)

    def transform(self, t, X, raw):
        S, v = X[:, 0:1], X[:, 1:2]
        tau = torch.clamp(self.T - t, min=0.0)
        sig = torch.sqrt(torch.clamp(v, min=1e-8))
        tc = torch.clamp(tau, min=1e-12)
        d1 = (torch.log(torch.clamp(S, min=1e-12) / self.strike)
              + (self.r + 0.5 * sig**2) * tc) / (sig * torch.sqrt(tc))
        d2 = d1 - sig * torch.sqrt(tc)
        price = S * _cdf(d1) - self.strike * torch.exp(-self.r * tc) * _cdf(d2)
        base = torch.where(tau <= 1e-12, torch.clamp(S - self.strike, min=0.0), price)
        return base + torch.sqrt(tau / self.T) * raw
