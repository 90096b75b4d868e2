"""The PDE problems ported so far: the flagship Black–Scholes–Barenblatt,
the GBM-type calls and baskets (diagonal dynamics μ = μ_c·X, σ = σ̄·diag(X)),
the Hamilton–Jacobi–Bellman equation, the optimal-stopping problems
(the American put and the Bermudan max-call) and the path-dependent
contracts (the up-and-out barrier, Asian and lookback calls). The Heston
problems are in ``pde/heston.py``.

Strike conventions as in the JAX package: K = 1.0·D for the 1D/nD calls
(``strike`` overrides it), K = 1.0 for the basket.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from dnnpde_tpu_torch.numerics.black_scholes import black_scholes_call
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


@dataclasses.dataclass(frozen=True)
class AmericanPutOption(PDEProblem):
    """American (Bermudan-N) put under Black–Scholes dynamics, an
    optimal-stopping problem.

    phi = r·Y, g = max(K − ΣX, 0), mu = r·X, sigma = σ̄·diag(X). Under the
    local objective the per-step regression target is clamped at the
    payoff, so the net learns the continuation value and the served value is
    max(g, u) (:meth:`PDEProblem.value_u`). With N solver steps the learned
    price is the Bermudan-N value; score it against
    ``numerics.crr_binomial(..., exercise_every=n_steps // N)``. Requires
    ``Trainer(objective="local")``.

    ``bs_head`` (D = 1 only, the default): u = euro_put(S, τ) +
    √(τ/T)·softplus(raw + head_shift), the closed-form European put (by
    put–call parity on the tanh-Φ call) plus a non-negative early-exercise
    premium; exact at τ = 0, so both terminal penalties vanish.
    """

    D: int = 1
    r: float = 0.06
    sigma_bar: float = 0.2
    strike: Optional[float] = None  # default 1.0 * D
    bs_head: bool = True
    head_shift: float = -3.0
    name: str = "AmericanPut"

    @property
    def dim(self) -> int:
        return self.D

    @property
    def early_exercise(self) -> bool:
        return True

    @property
    def has_output_transform(self) -> bool:
        return self.bs_head

    def transform_u(self, t, X, u):
        if not self.bs_head:
            return super().transform_u(t, X, u)
        if self.D != 1:
            raise ValueError("bs_head supports D=1 only")
        S = X[..., 0:1]
        tau = torch.clamp(self.T - t, min=0.0)
        euro = (black_scholes_call(S, self.K, tau, self.r, self.sigma_bar, cdf="tanh")
                - S + self.K * torch.exp(-self.r * tau))
        premium = torch.sqrt(tau / self.T) * F.softplus(u + self.head_shift)
        return euro + premium

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
        return torch.clamp(self.K - torch.sum(X, dim=-1, keepdim=True), min=0.0)


@dataclasses.dataclass(frozen=True)
class BermudanMaxCall(PDEProblem):
    """Bermudan max-call on d independent dividend-paying GBM assets
    (Broadie & Glasserman 1997; Andersen & Broadie 2004): K = 100, r = 5 %,
    dividend δ = 10 %, σ = 20 %, T = 3, nine equally spaced exercise dates.
    Published values: d = 2, S0 = 100: 13.902; d = 5: 26.15.

    The state is the log-prices x_i = ln S_i, so μ = (r − δ − σ²/2)·1 and
    σ = σ̄·1 are constant and the Euler step is the exact GBM transition;
    the driver φ = r̂·Y with r̂ = (e^{rΔt} − 1)/Δt makes the per-step
    discount (1 + r̂Δt)⁻¹ exactly e^{−rΔt}. The solver grid ``N_steps``
    is a multiple of ``n_exercise`` and :attr:`exercise_every` puts the
    Snell clamp on the contract's dates only.

    Payoff g(x) = max(max_i e^{x_i} − K, 0). The head (default) is
    max_i BSCall(S_i, τ; δ), a lower bound on the continuation value, plus
    √(τ/T)·softplus(raw + head_shift): exact at τ = 0.

    Requires ``Trainer(objective="local")``; grade against
    ``numerics.lsmc_value(problem, N, basis="sorted")`` and the published
    values.
    """

    D: int = 2
    S0: float = 100.0
    strike: float = 100.0
    r: float = 0.05
    delta: float = 0.10
    sigma_bar: float = 0.2
    T: float = 3.0
    n_exercise: int = 9
    N_steps: int = 45  # solver grid; must be a multiple of n_exercise
    head: bool = True
    head_shift: float = -3.0
    name: str = "BermudanMaxCall"

    def __post_init__(self):
        if self.N_steps % self.n_exercise:
            raise ValueError(
                f"N_steps={self.N_steps} must be a multiple of n_exercise={self.n_exercise}"
            )

    @property
    def dim(self) -> int:
        return self.D

    @property
    def K(self) -> float:
        return self.strike

    @property
    def early_exercise(self) -> bool:
        return True

    @property
    def exercise_every(self) -> int:
        return self.N_steps // self.n_exercise

    @property
    def N_samples(self) -> int:
        # r̂ depends on Δt = T / N_steps, so the Trainer's N must match
        return self.N_steps

    @property
    def dt(self) -> float:
        return self.T / self.N_steps

    @property
    def r_hat(self) -> float:
        """Per-step driver rate making (1 + r̂Δt)⁻¹ = e^{−rΔt} exact."""
        return float(math.expm1(self.r * self.dt) / self.dt)

    @property
    def x0(self) -> Tensor:
        return torch.log(torch.full((self.D,), self.S0, dtype=torch.float32))

    def mu(self, t, X, Y, Z):
        return torch.full_like(X, self.r - self.delta - 0.5 * self.sigma_bar**2)

    def sigma(self, t, X, Y):
        return torch.full_like(X, self.sigma_bar)

    def phi(self, t, X, Y, Z):
        return self.r_hat * Y

    def g(self, X):
        mx = torch.amax(torch.exp(X), dim=-1, keepdim=True)
        return torch.clamp(mx - self.K, min=0.0)

    @property
    def has_output_transform(self) -> bool:
        return self.head

    def transform_u(self, t, X, u):
        if not self.head:
            return u
        S = torch.exp(X)
        tau = torch.clamp(self.T - t, min=0.0)
        base = torch.amax(
            black_scholes_call(S, self.K, tau, self.r, self.sigma_bar, q=self.delta, cdf="tanh"),
            dim=-1, keepdim=True,
        )
        premium = torch.sqrt(tau / self.T) * F.softplus(u + self.head_shift)
        return base + premium


def _on_underlying(X: Tensor, c: float) -> Tensor:
    """(c·S, 0) for the two-coordinate path-dependent states: GBM on the
    underlying S, nothing on the path statistic between monitoring dates."""
    return torch.cat([c * X[..., 0:1], torch.zeros_like(X[..., 1:2])], dim=-1)


@dataclasses.dataclass(frozen=True)
class UpAndOutCall(PDEProblem):
    """Discretely-monitored up-and-out barrier call, a path-dependent payoff.

    State X = (S, a): the GBM underlying and a multiplicative alive
    indicator, updated at every solver step (= monitoring date) by
    :meth:`post_step`: a ← a·m(S) with m = 1{S < B} (``smooth_beta=None``)
    or the sigmoid σ(β(B − S)) (the smoothed monitor, the trainable
    default). The payoff is g = a·max(S − K, 0) and the value is linear in
    a, so the output transform is u = a·raw: knocked-out paths carry value
    0 identically. Works under both objectives; the oracle
    ``numerics.discrete_bsde_value`` runs the same post-step chain, so the
    grade is exact at any N and any smoothing.
    """

    r: float = 0.05
    sigma_bar: float = 0.2
    strike: float = 1.0
    barrier: float = 1.3
    smooth_beta: Optional[float] = 50.0
    name: str = "UpAndOutCall"

    @property
    def dim(self) -> int:
        return 2

    @property
    def has_post_step(self) -> bool:
        return True

    @property
    def has_output_transform(self) -> bool:
        return True

    @property
    def x0(self) -> Tensor:
        return torch.tensor([1.0, 1.0], dtype=torch.float32)

    def monitor(self, S: Tensor) -> Tensor:
        """Knock-out factor at one monitoring date: 1 below the barrier,
        0 above (smoothed by ``smooth_beta`` unless None)."""
        if self.smooth_beta is None:
            return (S < self.barrier).to(S.dtype)
        return torch.sigmoid(self.smooth_beta * (self.barrier - S))

    def post_step(self, t, X):
        S, a = X[..., 0:1], X[..., 1:2]
        return torch.cat([S, a * self.monitor(S)], dim=-1)

    def transform_u(self, t, X, u):
        return X[..., 1:2] * u

    def mu(self, t, X, Y, Z):
        return _on_underlying(X, self.r)

    def sigma(self, t, X, Y):
        return _on_underlying(X, self.sigma_bar)

    def phi(self, t, X, Y, Z):
        return self.r * Y

    def g(self, X):
        return X[..., 1:2] * torch.clamp(X[..., 0:1] - self.strike, min=0.0)


@dataclasses.dataclass(frozen=True)
class AsianCallOption(PDEProblem):
    """Discretely-sampled arithmetic-average Asian call, path-dependent
    through :meth:`post_step`.

    State X = (S, A): the GBM underlying and the running average of the N
    post-step samples, A ← A + S/N at each step (A0 = 0; at maturity the
    full discrete average). Payoff g = max(A − K, 0). ``N_samples`` must
    equal the Trainer's N. Both objectives apply; the exact oracle is
    ``numerics.discrete_bsde_value`` over the identical chain, and the
    geometric-average closed form lies below it (Jensen).
    """

    r: float = 0.05
    sigma_bar: float = 0.2
    strike: float = 1.0
    N_samples: int = 50  # must equal the Trainer's N (1/N weight per step)
    name: str = "AsianCall"

    @property
    def dim(self) -> int:
        return 2

    @property
    def has_post_step(self) -> bool:
        return True

    @property
    def x0(self) -> Tensor:
        return torch.tensor([1.0, 0.0], dtype=torch.float32)

    def post_step(self, t, X):
        S, A = X[..., 0:1], X[..., 1:2]
        return torch.cat([S, A + S / self.N_samples], dim=-1)

    def mu(self, t, X, Y, Z):
        return _on_underlying(X, self.r)

    def sigma(self, t, X, Y):
        return _on_underlying(X, self.sigma_bar)

    def phi(self, t, X, Y, Z):
        return self.r * Y

    def g(self, X):
        return torch.clamp(X[..., 1:2] - self.strike, min=0.0)


@dataclasses.dataclass(frozen=True)
class LookbackCallOption(PDEProblem):
    """Discretely-monitored floating-strike lookback call, path-dependent
    through :meth:`post_step`.

    State X = (S, m): the GBM underlying and the running minimum over the
    monitoring dates, m ← min(m, S) at each step (m0 = S0). Payoff
    g = S_N − m_N ≥ 0. Both objectives apply; exact oracle:
    ``numerics.discrete_bsde_value`` over the identical chain.
    """

    r: float = 0.05
    sigma_bar: float = 0.2
    name: str = "LookbackCall"

    @property
    def dim(self) -> int:
        return 2

    @property
    def has_post_step(self) -> bool:
        return True

    @property
    def x0(self) -> Tensor:
        return torch.tensor([1.0, 1.0], dtype=torch.float32)

    def post_step(self, t, X):
        S, m = X[..., 0:1], X[..., 1:2]
        return torch.cat([S, torch.minimum(m, S)], dim=-1)

    def mu(self, t, X, Y, Z):
        return _on_underlying(X, self.r)

    def sigma(self, t, X, Y):
        return _on_underlying(X, self.sigma_bar)

    def phi(self, t, X, Y, Z):
        return self.r * Y

    def g(self, X):
        return X[..., 0:1] - X[..., 1:2]
