"""Brownian path generation on a ``torch.Generator``.

Conventions: batch M, steps N, noise dim D.
  increments: dW (M, N, D); paths: W (M, N+1, D) with W[:, 0] = 0;
  time grid:  t  (M, N+1, 1) with t[:, n] = n·dt.

Increments are drawn on the generator's device.
"""

from __future__ import annotations

from typing import Optional

import torch

from dnnpde_tpu_torch.runtime import default_device

Tensor = torch.Tensor


def brownian_increments(
    generator: torch.Generator,
    M: int,
    N: int,
    D: int,
    dt: float,
    chol: Optional[Tensor] = None,
    dtype=torch.float32,
    antithetic: bool = False,
) -> Tensor:
    """√dt · N(0, I) increments, optionally correlated: dW ← dW · Lᵀ, with
    ``chol`` the lower Cholesky factor L of the correlation matrix.

    ``antithetic=True`` draws M/2 increments and mirrors them (dW, −dW);
    requires even M."""
    device = generator.device
    scale = float(dt) ** 0.5
    if antithetic:
        if M % 2:
            raise ValueError(f"antithetic sampling requires even M, got {M}")
        half = torch.randn((M // 2, N, D), generator=generator, dtype=dtype, device=device)
        dw = scale * torch.cat([half, -half], dim=0)
    else:
        dw = scale * torch.randn((M, N, D), generator=generator, dtype=dtype, device=device)
    if chol is not None:
        dw = dw @ chol.T.to(dtype=dtype, device=device)
    return dw


def time_grid(M: int, N: int, T: float, dtype=torch.float32, device=None) -> Tensor:
    """(M, N+1, 1) time grid t_n = n·dt with dt = T·(1/N) rounded in
    ``dtype`` and t_N = T: the values the JAX package's compiled
    ``linspace`` gives."""
    device = default_device(device)
    end = torch.full((1,), T, dtype=dtype, device=device)
    dt = end * torch.full((1,), 1.0 / N, dtype=dtype, device=device)
    t = torch.cat([torch.arange(N, dtype=dtype, device=device) * dt, end])
    return t.reshape(1, N + 1, 1).expand(M, N + 1, 1)


def brownian_paths(
    generator: torch.Generator,
    M: int,
    N: int,
    D: int,
    T: float,
    chol: Optional[Tensor] = None,
    dtype=torch.float32,
) -> tuple[Tensor, Tensor]:
    """Sample (t (M, N+1, 1), W (M, N+1, D)) with W[:, 0] = 0."""
    dw = brownian_increments(generator, M, N, D, T / N, chol, dtype)
    w = torch.cat([torch.zeros((M, 1, D), dtype=dtype, device=dw.device), dw.cumsum(dim=1)], dim=1)
    return time_grid(M, N, T, dtype, dw.device), w


def time_major_batch(
    generator: torch.Generator,
    M: int,
    N: int,
    D: int,
    T: float,
    chol: Optional[Tensor] = None,
    dtype=torch.float32,
) -> tuple[Tensor, Tensor]:
    """One training minibatch in the solver's time-major layout:
    (ts (N+1, M, 1), dWs (N, M, D))."""
    dW = brownian_increments(generator, M, N, D, T / N, chol, dtype)
    ts = time_grid(M, N, T, dtype, dW.device).transpose(0, 1)
    return ts, dW.transpose(0, 1)
