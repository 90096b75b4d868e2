"""PDE problem interface for the deep-BSDE solver (PyTorch port).

A problem defines the semilinear parabolic PDE

    u_t + ½ Tr[σσᵀ D²u] + μ·Du = φ(t, X, u, σᵀDu),   u(T, X) = g(X)

through batched functions on tensors. Problems are frozen dataclasses of
data plus methods, as in the JAX package.

Shape conventions (batch M, state dim D, noise dim Dw):
  t: (M, 1)   X: (M, D)   Y: (M, 1)   Z: (M, D)
  mu    → (M, D)
  sigma → (M, D) when ``sigma_kind == "diag"``, (M, D, Dw) when "full"
  phi   → (M, 1)
  g     → (M, 1)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PDEProblem:
    """Base problem. Subclasses override the dynamics/generator methods.

    ``x0`` is returned as a float32 CPU tensor; callers move it to their
    device. ``clamp_u`` (if set) clamps the network output at [clamp_u, ∞).
    """

    T: float = 1.0
    name: str = "pde"

    # --- static problem metadata --------------------------------------------
    @property
    def dim(self) -> int:
        raise NotImplementedError

    @property
    def noise_dim(self) -> int:
        return self.dim

    @property
    def sigma_kind(self) -> str:
        return "diag"

    @property
    def clamp_u(self) -> Optional[float]:
        return None

    @property
    def clamp_mode(self) -> str:
        """"hard" = max(u, clamp_u); "softplus" = clamp_u + softplus(β(u−c))/β."""
        return "hard"

    @property
    def clamp_beta(self) -> float:
        return 50.0

    @property
    def z_penalty_mask(self) -> Optional[Tensor]:
        """Optional (D,) 0/1 mask of the Z components in the terminal
        gradient penalty; None → all."""
        return None

    @property
    def has_post_step(self) -> bool:
        """True when :meth:`post_step` is not the identity."""
        return False

    def post_step(self, t: Tensor, X: Tensor) -> Tensor:
        """State map applied after every Euler step; identity by default."""
        return X

    @property
    def early_exercise(self) -> bool:
        """True for optimal-stopping (American/Bermudan) problems. The local
        objective then clamps the per-step regression target at the payoff
        at every exercise date (the Snell-envelope recursion
        V_k = max(g(X_k), E_k[V_{k+1}] − φΔt)), so the net learns the
        continuation value and the served value is :meth:`value_u`.
        Requires ``objective="local"``."""
        return False

    @property
    def exercise_every(self) -> int:
        """Exercise-date spacing in solver steps for early-exercise
        problems: exercise is allowed at grid indices k, 2k, …, N (maturity
        always included; immediate exercise at t = 0 is the outer
        ``max(g(x0), ·)`` read). 1 (default) = a date at every step. The
        solver requires N % exercise_every == 0."""
        return 1

    def value_u(self, X: Tensor, u: Tensor) -> Tensor:
        """Served value given the net's output u at (t, X): the identity for
        European-style problems; the Snell read max(g(X), u) for
        early-exercise problems (u is the learned continuation)."""
        return torch.maximum(self.g(X), u) if self.early_exercise else u

    @property
    def x0(self) -> Tensor:
        raise NotImplementedError

    # --- output transform ----------------------------------------------------
    @property
    def has_output_transform(self) -> bool:
        """True when :meth:`transform_u` is not the identity."""
        return self.clamp_u is not None

    def transform_u(self, t: Tensor, X: Tensor, u: Tensor) -> Tensor:
        """Map the raw network output to the solution value u(t, X); must stay
        differentiable, since Z = ∇ₓ(transform_u∘net)."""
        c = self.clamp_u
        if c is None:
            return u
        mode = self.clamp_mode
        if mode == "softplus":
            return c + F.softplus(self.clamp_beta * (u - c)) / self.clamp_beta
        if mode == "hard":
            return torch.clamp(u, min=c)
        raise ValueError(f"unknown clamp_mode {mode!r}")

    # --- dynamics / generator ------------------------------------------------
    def mu(self, t: Tensor, X: Tensor, Y: Tensor, Z: Tensor) -> Tensor:
        """SDE drift, (M, D)."""
        raise NotImplementedError

    def sigma(self, t: Tensor, X: Tensor, Y: Tensor) -> Tensor:
        """SDE diffusion, (M, D) diag or (M, D, Dw) full."""
        raise NotImplementedError

    def phi(self, t: Tensor, X: Tensor, Y: Tensor, Z: Tensor) -> Tensor:
        """BSDE generator φ, (M, 1)."""
        raise NotImplementedError

    def g(self, X: Tensor) -> Tensor:
        """Terminal condition, (M, 1)."""
        raise NotImplementedError

    def Dg(self, X: Tensor) -> Tensor:
        """Gradient of g w.r.t. X, (M, D), by autograd of Σg (g is per-sample,
        so one reverse pass gives the batched Jacobian).

        Under grad mode with an X that carries a graph, the result keeps the
        graph (``create_graph``), so a loss on Dg(X) is differentiable in
        whatever X depends on, as ``jax.grad`` of Σg is."""
        if torch.is_grad_enabled() and X.requires_grad:
            (grad,) = torch.autograd.grad(self.g(X).sum(), X, create_graph=True)
            return grad
        with torch.enable_grad():
            x = X.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(self.g(x).sum(), x)
        return grad

    # --- optional oracle -----------------------------------------------------
    def exact_solution(self, t: Tensor, X: Tensor) -> Optional[Tensor]:
        """Closed-form u(t, X) when known, else None."""
        return None

    # --- diffusion application helper ----------------------------------------
    def sigma_dw(self, sig: Tensor, dW: Tensor) -> Tensor:
        """Apply diffusion to a Brownian increment: σ·ΔW, (M, D)."""
        if self.sigma_kind == "diag":
            return sig * dW
        return torch.einsum("mij,mj->mi", sig, dW)

    def z_sigma_dw(self, Z: Tensor, sig: Tensor, dW: Tensor) -> Tensor:
        """BSDE martingale term Zᵀ(σ·ΔW) summed over dims, (M, 1)."""
        return torch.sum(Z * self.sigma_dw(sig, dW), dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class CallableProblem(PDEProblem):
    """Problem assembled from plain functions (user extension / tests),
    which take and return tensors.

    The dynamics fields use ``_fn`` suffixes so they cannot shadow the
    :class:`PDEProblem` methods they implement. ``x0_`` is a tuple, so the
    problem stays hashable."""

    dim_: int = 1
    sigma_kind_: str = "diag"
    x0_: tuple = (1.0,)
    mu_fn: Optional[Callable] = None
    sigma_fn: Optional[Callable] = None
    phi_fn: Optional[Callable] = None
    g_fn: Optional[Callable] = None
    exact_fn: Optional[Callable] = None

    @property
    def dim(self) -> int:
        return self.dim_

    @property
    def sigma_kind(self) -> str:
        return self.sigma_kind_

    @property
    def x0(self) -> Tensor:
        return torch.tensor(self.x0_, dtype=torch.float32).reshape(self.dim_)

    def mu(self, t, X, Y, Z):
        return self.mu_fn(t, X, Y, Z)

    def sigma(self, t, X, Y):
        return self.sigma_fn(t, X, Y)

    def phi(self, t, X, Y, Z):
        return self.phi_fn(t, X, Y, Z)

    def g(self, X):
        return self.g_fn(X)

    def exact_solution(self, t, X):
        return self.exact_fn(t, X) if self.exact_fn is not None else None


def as_callable_problem(
    *,
    dim: int,
    T: float,
    x0,
    mu: Callable,
    sigma: Callable,
    phi: Callable,
    g: Callable,
    sigma_kind: str = "diag",
    name: str = "custom",
    exact: Optional[Callable] = None,
) -> PDEProblem:
    """Build an ad-hoc problem from plain functions on tensors (for user
    extension and tests)."""
    x0 = torch.as_tensor(x0, dtype=torch.float64).reshape(dim)
    return CallableProblem(
        T=T, name=name, dim_=dim, sigma_kind_=sigma_kind, x0_=tuple(x0.tolist()),
        mu_fn=mu, sigma_fn=sigma, phi_fn=phi, g_fn=g, exact_fn=exact,
    )
