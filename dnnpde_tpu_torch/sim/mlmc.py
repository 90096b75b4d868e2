"""Multilevel Monte Carlo (MLMC): coupled-level Brownian increments and the
Giles estimator, the counterpart of ``dnnpde_tpu/sim/mlmc.py``.

- :func:`coupled_brownian_increments`: fine-level increments and the exact
  coarse-level increments, sums of ``factor`` fine ones, so both levels see
  the same Brownian path.
- :func:`mlmc_gbm_price`: E[P_L] = E[P_0] + Σ_ℓ E[P_ℓ − P_{ℓ−1}] under the
  Euler scheme, with M_ℓ = M₀·M_const^{−ℓ} samples at level ℓ and coupled
  paths in each correction.
- :func:`mlmc_minibatch`: a coupled two-resolution BSDE minibatch.

Every draw comes from the explicit ``torch.Generator`` passed in, on its
device, as the Trainer draws: level 0 first, then each correction level in
order (the JAX module splits one key per level instead, so the two agree in
distribution, not draw by draw).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from dnnpde_tpu_torch.sim.brownian import brownian_increments, time_grid

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MLMCConfig:
    """``num_levels`` levels; level ℓ has N₀·M_const^ℓ steps and
    M₀·M_const^{−ℓ} samples (at least 2)."""

    num_levels: int = 3
    M_const: int = 2
    N0: int = 8
    M0: int = 4096

    def steps_at(self, level: int) -> int:
        return self.N0 * self.M_const**level

    def samples_at(self, level: int) -> int:
        return max(self.M0 // (self.M_const**level), 2)


def coupled_brownian_increments(
    generator: torch.Generator, M: int, N_fine: int, D: int, dt_fine: float, factor: int,
    chol: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """(dW_fine (M, N_fine, D), dW_coarse (M, N_fine/factor, D)) on the same
    Brownian path: each coarse increment is the sum of ``factor`` fine ones."""
    if N_fine % factor != 0:
        raise ValueError(f"N_fine={N_fine} not divisible by factor={factor}")
    dw_f = brownian_increments(generator, M, N_fine, D, dt_fine, chol)
    return dw_f, dw_f.reshape(M, N_fine // factor, factor, D).sum(dim=2)


def _euler_gbm_terminal(x0: Tensor, r: float, sigma: Tensor, dW: Tensor, dt: float) -> Tensor:
    """Euler (not exact) GBM terminal values, (M, D): the scheme whose weak
    error MLMC trades against."""
    x = x0
    for n in range(dW.shape[1]):
        x = x * (1.0 + r * dt + sigma * dW[:, n])
    return x


def _basket_payoff(ST: Tensor, K: float, payoff: str) -> Tensor:
    agg = torch.mean(ST, dim=-1) if payoff == "mean" else torch.sum(ST, dim=-1)
    return torch.clamp(agg - K, min=0.0)


def mlmc_gbm_price(
    generator: torch.Generator, S0, K: float, T: float, r: float, sigma,
    config: MLMCConfig = MLMCConfig(), chol: Optional[Tensor] = None, payoff: str = "mean",
) -> tuple[Tensor, Tensor, dict]:
    """Giles MLMC estimate of the discounted basket call under Euler GBM, on
    the generator's device: (price, standard_error, per-level diagnostics).
    Level 0 takes N₀ steps; each correction ℓ ≥ 1 takes coupled (fine,
    coarse) paths at (N₀·k^ℓ, N₀·k^{ℓ−1}) steps, k = M_const."""
    dev = generator.device
    S0 = torch.atleast_1d(torch.as_tensor(S0, dtype=torch.float32)).to(dev)
    D = S0.shape[0]
    sig = torch.as_tensor(sigma, dtype=torch.float32).to(dev).expand(D)
    disc = math.exp(-r * T)
    diagnostics = {}

    def term(p: Tensor, level: int, M: int):
        mean, var = torch.mean(p), torch.var(p, correction=0)
        diagnostics[level] = {"mean": float(mean), "var": float(var), "M": M}
        return mean, var / M

    M0, N0 = config.samples_at(0), config.steps_at(0)
    dW0 = brownian_increments(generator, M0, N0, D, T / N0, chol)
    p0 = disc * _basket_payoff(_euler_gbm_terminal(S0.expand(M0, D), r, sig, dW0, T / N0),
                               K, payoff)
    total, var_total = term(p0, 0, M0)
    for lvl in range(1, config.num_levels):
        Ml, Nf, Nc = config.samples_at(lvl), config.steps_at(lvl), config.steps_at(lvl - 1)
        dw_f, dw_c = coupled_brownian_increments(generator, Ml, Nf, D, T / Nf, config.M_const,
                                                 chol)
        xl = S0.expand(Ml, D)
        pf = disc * _basket_payoff(_euler_gbm_terminal(xl, r, sig, dw_f, T / Nf), K, payoff)
        pc = disc * _basket_payoff(_euler_gbm_terminal(xl, r, sig, dw_c, T / Nc), K, payoff)
        mean, var = term(pf - pc, lvl, Ml)
        total, var_total = total + mean, var_total + var
    return total, torch.sqrt(var_total), diagnostics


def mlmc_minibatch(
    generator: torch.Generator, M: int, N_fine: int, D: int, T: float, factor: int = 2,
    chol: Optional[Tensor] = None,
) -> tuple[tuple[Tensor, Tensor], tuple[Tensor, Tensor]]:
    """Coupled two-resolution BSDE minibatch ((t_f, W_f), (t_c, W_c)) with
    W_c the exact coarsening of W_f, on the generator's device."""
    dw_f, dw_c = coupled_brownian_increments(generator, M, N_fine, D, T / N_fine, factor, chol)

    def paths(dw: Tensor, n: int) -> tuple[Tensor, Tensor]:
        w = torch.cat([torch.zeros((M, 1, D), dtype=dw.dtype, device=dw.device),
                       torch.cumsum(dw, dim=1)], dim=1)
        return time_grid(M, n, T, dw.dtype, dw.device), w

    return paths(dw_f, N_fine), paths(dw_c, N_fine // factor)
