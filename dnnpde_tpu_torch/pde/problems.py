"""The PDE problems ported so far: the flagship Black–Scholes–Barenblatt."""

from __future__ import annotations

import dataclasses

import torch

from dnnpde_tpu_torch.pde.base import PDEProblem, Tensor


def _ones_x0(dim: int, lo: float = 1.0, hi: float = 0.5) -> Tensor:
    """Reference initial condition: alternating [1, 0.5, 1, 0.5, ...]."""
    base = torch.tensor([lo, hi], dtype=torch.float32).repeat((dim + 1) // 2)
    return base[:dim]


@dataclasses.dataclass(frozen=True)
class BlackScholesBarenblatt(PDEProblem):
    """100D Black–Scholes–Barenblatt equation.

    phi = r(Y − ΣXZ), g = Σ X², mu = 0, sigma = σ_bar·diag(X), with closed
    form u(t,X) = exp((r + σ̄²)(T − t))·ΣX².
    """

    D: int = 100
    r: float = 0.05
    sigma_bar: float = 0.4
    name: str = "BlackScholesBarenblatt"

    @property
    def dim(self) -> int:
        return self.D

    @property
    def x0(self) -> Tensor:
        return _ones_x0(self.D)

    def mu(self, t, X, Y, Z):
        return torch.zeros_like(X)

    def sigma(self, t, X, Y):
        return self.sigma_bar * X

    def phi(self, t, X, Y, Z):
        return self.r * (Y - torch.sum(X * Z, dim=-1, keepdim=True))

    def g(self, X):
        return torch.sum(X**2, dim=-1, keepdim=True)

    def exact_solution(self, t, X):
        return torch.exp((self.r + self.sigma_bar**2) * (self.T - t)) * torch.sum(
            X**2, dim=-1, keepdim=True
        )
