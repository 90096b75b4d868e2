"""The PDE problems ported so far: the flagship Black–Scholes–Barenblatt,
the GBM-type calls and baskets (diagonal dynamics μ = μ_c·X, σ = σ̄·diag(X))
and the Hamilton–Jacobi–Bellman equation. The Heston problem is in
``pde/heston.py``.

Strike conventions as in the JAX package: K = 1.0·D for the 1D/nD calls
(``strike`` overrides it), K = 1.0 for the basket.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

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


@dataclasses.dataclass(frozen=True)
class CallOption1D(PDEProblem):
    """1D European call under Black–Scholes dynamics.

    phi = r·Y, g = max(ΣX − K, 0), mu = r·X, sigma = σ̄·diag(X) with
    r = 0.01, σ̄ = 0.25 and strike K = 1.0·D unless ``strike`` is given.
    """

    D: int = 1
    r: float = 0.01
    sigma_bar: float = 0.25
    strike: Optional[float] = None  # default 1.0 * D
    name: str = "CallOption1D"

    @property
    def dim(self) -> int:
        return self.D

    @property
    def K(self) -> float:
        return 1.0 * self.D if self.strike is None else self.strike

    @property
    def x0(self) -> Tensor:
        return torch.ones((self.D,), dtype=torch.float32)

    def mu(self, t, X, Y, Z):
        return self.r * X

    def sigma(self, t, X, Y):
        return self.sigma_bar * X

    def phi(self, t, X, Y, Z):
        return self.r * Y

    def g(self, X):
        return torch.clamp(torch.sum(X, dim=-1, keepdim=True) - self.K, min=0.0)


@dataclasses.dataclass(frozen=True)
class CallOptionND(PDEProblem):
    """nD call in BSB form: phi = r(Y − ΣXZ), g = max(ΣX − K, 0),
    mu = r·X, sigma = σ̄·diag(X); r = 0.05, σ̄ = 0.20, K = 1.0·D.

    The BSB-form generator with drift r·X gives the PDE
    u_t + 2r·X·Du + ½σ̄²X²D²u − r·u = 0: the value is e^{−rT}·E[g(X_T)]
    with X simulated at drift 2r, not the Black–Scholes price at drift r.
    :class:`BasketCallOption` (generator r·Y) is the risk-neutral contract.
    """

    D: int = 100
    r: float = 0.05
    sigma_bar: float = 0.20
    strike: Optional[float] = None
    name: str = "CallOptionND"

    @property
    def dim(self) -> int:
        return self.D

    @property
    def K(self) -> float:
        return 1.0 * self.D if self.strike is None else self.strike

    @property
    def x0(self) -> Tensor:
        return _ones_x0(self.D)

    def mu(self, t, X, Y, Z):
        return self.r * X

    def sigma(self, t, X, Y):
        return self.sigma_bar * X

    def phi(self, t, X, Y, Z):
        return self.r * (Y - torch.sum(X * Z, dim=-1, keepdim=True))

    def g(self, X):
        return torch.clamp(torch.sum(X, dim=-1, keepdim=True) - self.K, min=0.0)


@dataclasses.dataclass(frozen=True)
class BasketCallOption(PDEProblem):
    """Basket call: phi = r·Y, g = max(mean(X) − K, 0), mu = r·X,
    sigma = σ̄·diag(X); r = 0.05, σ̄ = 0.20, K = 1.0. ``weights`` (length D)
    replaces the equal-weight mean by Σ wᵢXᵢ.

    Correlated increments come from the path engine's Cholesky factor, not
    from the problem.
    """

    D: int = 100
    r: float = 0.05
    sigma_bar: float = 0.20
    strike: float = 1.0
    weights: Optional[tuple] = None  # None → equal-weight mean basket
    name: str = "BasketCallOption"

    def __post_init__(self):
        if self.weights is not None and len(self.weights) != self.D:
            raise ValueError(
                f"weights must have length D={self.D}, got {len(self.weights)}"
            )

    @property
    def dim(self) -> int:
        return self.D

    @property
    def x0(self) -> Tensor:
        return torch.ones((self.D,), dtype=torch.float32)

    def mu(self, t, X, Y, Z):
        return self.r * X

    def sigma(self, t, X, Y):
        return self.sigma_bar * X

    def phi(self, t, X, Y, Z):
        return self.r * Y

    def g(self, X):
        if self.weights is not None:
            w = torch.as_tensor(self.weights, dtype=X.dtype, device=X.device)
            basket = torch.sum(X * w, dim=-1, keepdim=True)
        else:
            basket = torch.mean(X, dim=-1, keepdim=True)
        return torch.clamp(basket - self.strike, min=0.0)


@dataclasses.dataclass(frozen=True)
class BSPDETestCase(PDEProblem):
    """BSB test case with drift: phi = r(Y − ΣXZ), g = ΣX², mu = r·X,
    sigma = σ̄·diag(X).

    With drift r·X the PDE is u_t + 2r·X·Du + ½σ̄²X²D²u − r·u = 0, solved by
    e^{(3r+σ̄²)(T−t)}ΣX² (:meth:`exact_solution`). The μ = 0 BSB formula
    e^{(r+σ̄²)(T−t)}ΣX², which the reference compares against, is
    :meth:`reference_exact_solution`.
    """

    D: int = 100
    r: float = 0.05
    sigma_bar: float = 0.20
    name: str = "BSPDETestCase"

    @property
    def dim(self) -> int:
        return self.D

    @property
    def x0(self) -> Tensor:
        return _ones_x0(self.D)

    def mu(self, t, X, Y, Z):
        return self.r * X

    def sigma(self, t, X, Y):
        return self.sigma_bar * X

    def phi(self, t, X, Y, Z):
        return self.r * (Y - torch.sum(X * Z, dim=-1, keepdim=True))

    def g(self, X):
        return torch.sum(X**2, dim=-1, keepdim=True)

    def exact_solution(self, t, X):
        return torch.exp((3 * self.r + self.sigma_bar**2) * (self.T - t)) * torch.sum(
            X**2, dim=-1, keepdim=True
        )

    def reference_exact_solution(self, t, X):
        """The μ = 0 BSB formula (incorrect for μ = r·X)."""
        return torch.exp((self.r + self.sigma_bar**2) * (self.T - t)) * torch.sum(
            X**2, dim=-1, keepdim=True
        )


@dataclasses.dataclass(frozen=True)
class HamiltonJacobiBellman(PDEProblem):
    """HJB equation: phi = ‖Z‖², g = log(½ + ½‖X‖²), mu = 0, sigma = √2·I,
    x0 = 0. The exact u(t,x) = −log E[exp(−g(x + √(2(T−t))·W))] is the
    Monte-Carlo oracle ``numerics.hjb_exact_mc``."""

    D: int = 100
    name: str = "HamiltonJacobiBellman"

    @property
    def dim(self) -> int:
        return self.D

    @property
    def x0(self) -> Tensor:
        return torch.zeros((self.D,), dtype=torch.float32)

    def mu(self, t, X, Y, Z):
        return torch.zeros_like(X)

    def sigma(self, t, X, Y):
        return torch.full_like(X, math.sqrt(2.0))

    def phi(self, t, X, Y, Z):
        return torch.sum(Z**2, dim=-1, keepdim=True)

    def g(self, X):
        return torch.log(0.5 + 0.5 * torch.sum(X**2, dim=-1, keepdim=True))
