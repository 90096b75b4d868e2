"""Forward-SDE simulation: Euler–Maruyama over given increments and
exact-scheme GBM paths, the counterpart of ``dnnpde_tpu/sim/euler_maruyama.py``.

The JAX package compiles the N-step loop into one ``lax.scan``; here it is a
Python loop, since PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dnnpde_tpu_torch.sim.brownian import brownian_increments

Tensor = torch.Tensor


def euler_maruyama(
    mu: Callable[[Tensor, Tensor], Tensor],
    sigma_dw: Callable[[Tensor, Tensor, Tensor], Tensor],
    x0: Tensor,
    dW: Tensor,
    dt: float,
    t0: float = 0.0,
) -> Tensor:
    """Roll X_{n+1} = X_n + mu(t, X)·dt + sigma_dw(t, X, dW_n) over N steps.

    Args:
      mu: drift, (M, D) ← (t, X) with t a 0-d tensor.
      sigma_dw: applied diffusion increment σ(t, X)·ΔW, (M, D).
      x0: (M, D) initial states.
      dW: (M, N, D) Brownian increments.
      dt: step size.

    Returns: X paths, (M, N+1, D), on x0's device.
    """
    t = torch.tensor(t0, dtype=x0.dtype, device=x0.device)
    xs = [x0]
    x = x0
    for n in range(dW.shape[1]):
        x = x + mu(t, x) * dt + sigma_dw(t, x, dW[:, n])
        t = t + dt
        xs.append(x)
    return torch.stack(xs, dim=1)


def gbm_paths(
    generator: torch.Generator,
    S0,
    r: float,
    sigma,
    T: float,
    N: int,
    M: int,
    chol: Optional[Tensor] = None,
    antithetic: bool = False,
) -> Tensor:
    """Exact-scheme geometric Brownian motion paths (log-Euler), (M, N+1, D).

    S_{n+1} = S_n · exp((r − σ²/2)dt + σ·ΔW̃) with ΔW̃ optionally correlated
    by the lower Cholesky factor ``chol``. ``antithetic`` pairs ΔW with −ΔW
    (M must be even). The paths are drawn on the generator's device.
    """
    device = generator.device
    S0 = torch.atleast_1d(torch.as_tensor(S0, dtype=torch.float32)).to(device)
    D = S0.shape[-1]
    dt = T / N
    if antithetic and M % 2 != 0:
        raise ValueError(f"antithetic sampling requires even M, got {M}")
    if chol is not None:
        chol = torch.as_tensor(chol, dtype=torch.float32)
    dw = brownian_increments(generator, M, N, D, dt, chol, antithetic=antithetic)
    sigma = torch.as_tensor(sigma, dtype=torch.float32).to(device).expand(D)
    log_steps = (r - 0.5 * sigma**2) * dt + sigma * dw
    paths = S0 * torch.exp(torch.cumsum(log_steps, dim=1))
    return torch.cat([S0.expand(M, 1, D), paths], dim=1)
