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
from typing import Optional

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
        so one reverse pass gives the batched Jacobian)."""
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
