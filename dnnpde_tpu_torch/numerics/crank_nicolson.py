"""Crank–Nicolson finite-difference solver for the Heston PDE, the
counterpart of ``dnnpde_tpu/numerics/crank_nicolson.py``:

  U_τ = ½vS² U_SS + ρσvS U_Sv + ½σ²v U_vv + rS U_S + κ(θ−v) U_v − rU

solved forward in time to maturity τ from the call payoff, with Dirichlet
conditions at the S boundaries, one-sided differences at the v boundaries,
and bilinear interpolation of the solution at (S0, v0); Δ/Γ by central
differences on the grid.

The operator does not depend on time, so the implicit matrix is
LU-factorised once (``torch.linalg.lu_factor``), as is the fully implicit
one of Rannacher's two start-up steps, and every step is one matvec and one
``lu_solve``. The dense operator is assembled once with NumPy in float64
and then computed in ``dtype`` (float32 by default, as the JAX package
computes without x64) on ``device`` (None → the first CUDA card).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dnnpde_tpu_torch.numerics.heston import HestonParams
from dnnpde_tpu_torch.runtime import default_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CNGrid:
    """Grid spec (reference defaults S_max = 2K, v_max = 0.5, 50×25×1000)."""

    S_max: float
    v_max: float = 0.5
    n_S: int = 50
    n_v: int = 25
    n_t: int = 1000


def _build_operator(p: HestonParams, grid: CNGrid) -> np.ndarray:
    """Dense spatial operator A over the n_S·n_v unknowns (S-major): central
    differences inside, one-sided first derivatives at v = 0 and v = v_max;
    the S-boundary rows stay empty (Dirichlet, imposed each step)."""
    nS, nv = grid.n_S, grid.n_v
    S = np.linspace(0.0, grid.S_max, nS)
    v = np.linspace(0.0, grid.v_max, nv)
    dS = S[1] - S[0]
    dv = v[1] - v[0]
    A = np.zeros((nS * nv, nS * nv))

    def idx(i, j):  # S index i, v index j
        return i * nv + j

    for i in range(1, nS - 1):
        for j in range(nv):
            row = idx(i, j)
            si, vj = S[i], v[j]
            c_ss = 0.5 * vj * si**2 / dS**2  # ½vS² U_SS
            A[row, idx(i - 1, j)] += c_ss
            A[row, idx(i, j)] += -2 * c_ss
            A[row, idx(i + 1, j)] += c_ss
            c_s = p.r * si / (2 * dS)  # rS U_S
            A[row, idx(i + 1, j)] += c_s
            A[row, idx(i - 1, j)] += -c_s
            A[row, idx(i, j)] += -p.r  # −rU
            c_v = p.kappa * (p.theta - vj) / dv  # κ(θ−v) U_v
            if j == 0:
                A[row, idx(i, 1)] += c_v
                A[row, idx(i, 0)] += -c_v
            elif j == nv - 1:
                A[row, idx(i, nv - 1)] += c_v
                A[row, idx(i, nv - 2)] += -c_v
            else:
                A[row, idx(i, j + 1)] += c_v / 2
                A[row, idx(i, j - 1)] += -c_v / 2
            if 0 < j < nv - 1:
                c_vv = 0.5 * p.sigma**2 * vj / dv**2  # ½σ²v U_vv
                A[row, idx(i, j - 1)] += c_vv
                A[row, idx(i, j)] += -2 * c_vv
                A[row, idx(i, j + 1)] += c_vv
                c_sv = p.rho * p.sigma * vj * si / (4 * dS * dv)  # ρσvS U_Sv
                A[row, idx(i + 1, j + 1)] += c_sv
                A[row, idx(i - 1, j - 1)] += c_sv
                A[row, idx(i + 1, j - 1)] += -c_sv
                A[row, idx(i - 1, j + 1)] += -c_sv
    return A


def crank_nicolson_heston(
    S0: float, params: HestonParams | None = None, grid: CNGrid | None = None,
    dtype: torch.dtype = torch.float32, device=None,
) -> tuple[float, Tensor, Tensor, Tensor]:
    """Solve the Heston PDE by CN; returns (price at (S0, v0), U grid
    (n_S, n_v), S, v)."""
    dev = default_device(device)
    p = params or HestonParams()
    g = grid or CNGrid(S_max=2 * p.K)
    nS, nv = g.n_S, g.n_v
    n = nS * nv
    dt = p.T / g.n_t

    A = _build_operator(p, g)
    A[:nv, :] = 0.0  # Dirichlet rows (S = 0 and S = S_max): identity rows in both
    A[-nv:, :] = 0.0  # operators, the value injected through the right-hand side
    eye = np.eye(n)

    def on_dev(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    expl = on_dev(eye + 0.5 * dt * A)
    lu, piv = torch.linalg.lu_factor(on_dev(eye - 0.5 * dt * A))
    # Rannacher start-up: fully implicit Euler for the first steps damps the
    # CN oscillations seeded by the kinked payoff
    lu_ie, piv_ie = torch.linalg.lu_factor(on_dev(eye - dt * A))

    S = np.linspace(0.0, g.S_max, nS)
    v = np.linspace(0.0, g.v_max, nv)
    u = on_dev(np.maximum(S[:, None] - p.K, 0.0) * np.ones((1, nv))).reshape(n, 1)
    interior = torch.ones(n, 1, dtype=dtype, device=dev)
    interior[:nv] = 0.0
    interior[-nv:] = 0.0
    upper = torch.zeros(n, 1, dtype=dtype, device=dev)
    upper[-nv:] = 1.0

    def apply_bc(rhs, k):
        # U(τ, 0, v) = 0; U(τ, S_max, v) = S_max − K e^{−rτ}, τ = (k + 1)Δt
        tau = (k + 1) * dt
        return rhs * interior + upper * (g.S_max - p.K * math.exp(-p.r * tau))

    rannacher = 2
    for k in range(rannacher):
        u = torch.linalg.lu_solve(lu_ie, piv_ie, apply_bc(u, k))
    for k in range(rannacher, g.n_t):
        u = torch.linalg.lu_solve(lu, piv, apply_bc(expl @ u, k))
    U = u.reshape(nS, nv)
    S_t, v_t = on_dev(S), on_dev(v)
    price = float(bilinear_interpolate(U, S_t, v_t, S0, p.v0))
    return price, U, S_t, v_t


def bilinear_interpolate(U: Tensor, S: Tensor, v: Tensor, s0: float, v0: float) -> Tensor:
    """Bilinear interpolation of an (nS, nv) grid at (s0, v0)."""
    i = int(torch.clamp(torch.searchsorted(S, torch.tensor([s0], dtype=S.dtype,
                                                           device=S.device)) - 1,
                        0, S.shape[0] - 2))
    j = int(torch.clamp(torch.searchsorted(v, torch.tensor([v0], dtype=v.dtype,
                                                           device=v.device)) - 1,
                        0, v.shape[0] - 2))
    ws = (s0 - S[i]) / (S[i + 1] - S[i])
    wv = (v0 - v[j]) / (v[j + 1] - v[j])
    return (
        U[i, j] * (1 - ws) * (1 - wv)
        + U[i + 1, j] * ws * (1 - wv)
        + U[i, j + 1] * (1 - ws) * wv
        + U[i + 1, j + 1] * ws * wv
    )


def cn_delta_gamma(U: Tensor, S: Tensor, v: Tensor, v0: float) -> tuple[Tensor, Tensor]:
    """Δ and Γ along the S axis at v = v0 by central differences."""
    j = int(torch.clamp(torch.searchsorted(v, torch.tensor([v0], dtype=v.dtype,
                                                           device=v.device)),
                        0, v.shape[0] - 1))
    col = U[:, j]
    dS = S[1] - S[0]
    delta = (col[2:] - col[:-2]) / (2 * dS)
    gamma = (col[2:] - 2 * col[1:-1] + col[:-2]) / dS**2
    return delta, gamma
