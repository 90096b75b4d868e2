"""Black–Scholes–Barenblatt in D dimensions (Raissi, arXiv:1804.07010,
§4.2): dX = σ̄ diag(X) dW, μ = 0, φ = r (Y − Σ X Z), g = Σ X², x0 =
(1, 0.5, 1, 0.5, ...), T = 1, r = 0.05, σ̄ = 0.4."""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Problem:
    D: int = 100
    r: float = 0.05
    sigma_bar: float = 0.4
    T: float = 1.0

    @property
    def dim(self) -> int:
        return self.D

    def x0(self, device) -> Tensor:
        x = torch.tensor([1.0, 0.5], dtype=torch.float32).repeat((self.D + 1) // 2)[: self.D]
        return x.to(device)

    @property
    def gbm(self) -> tuple[float, float]:
        """(μ_c, σ_c) of the GBM-type dynamics μ(X) = μ_c X, σ(X) = σ_c diag(X)."""
        return 0.0, self.sigma_bar

    def drift(self, t, X, Y, Z):
        return torch.zeros_like(X)

    def diffuse(self, t, X, Y, dW):
        """σ(t, X) ΔW."""
        return self.sigma_bar * X * dW

    def phi(self, t, X, Y, Z):
        return self.r * (Y - torch.sum(X * Z, dim=-1, keepdim=True))

    def g(self, X):
        return torch.sum(X * X, dim=-1, keepdim=True)

    def dg(self, X):
        return 2.0 * X

    z_mask = None
    transform = None
