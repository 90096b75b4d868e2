"""The basket call in D dimensions (the original repository's
``BasketOption``, its NAIS-Net sweep in ``high_dimension_test.py``):
dX = r X dt + σ̄ diag(X) dW with independent increments, φ = r Y,
g = max(mean(X) − K, 0), x0 = (1, ..., 1), T = 1, r = 0.05, σ̄ = 0.2, K = 1."""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Problem:
    D: int = 100
    r: float = 0.05
    sigma_bar: float = 0.2
    strike: float = 1.0
    T: float = 1.0

    @property
    def dim(self) -> int:
        return self.D

    def x0(self, device) -> Tensor:
        return torch.ones(self.D, dtype=torch.float32, device=device)

    @property
    def gbm(self) -> tuple[float, float]:
        """(μ_c, σ_c) of the GBM-type dynamics μ(X) = μ_c X, σ(X) = σ_c diag(X)."""
        return self.r, self.sigma_bar

    def drift(self, t, X, Y, Z):
        return self.r * X

    def diffuse(self, t, X, Y, dW):
        """σ(t, X) ΔW."""
        return self.sigma_bar * X * dW

    def phi(self, t, X, Y, Z):
        return self.r * Y

    def g(self, X):
        return torch.clamp(torch.mean(X, dim=-1, keepdim=True) - self.strike, min=0.0)

    def dg(self, X):
        """∇g: 1/D in every coordinate where the basket is at or above the
        strike (clamp's derivative at the kink is taken as 1), else 0."""
        above = torch.mean(X, dim=-1, keepdim=True) >= self.strike
        return torch.where(above, 1.0 / self.D, 0.0).expand_as(X)

    z_mask = None
    transform = None
