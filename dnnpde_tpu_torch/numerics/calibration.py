"""Differentiable Heston calibration: fit (κ, θ, σ_v, ρ, v0) to option
quotes, the counterpart of ``dnnpde_tpu/numerics/calibration.py``.

The closed form (``numerics/heston.py``: fixed-order Gauss–Legendre on
complex tensors) carries autograd through every model parameter, so the fit
is Adam on the exact pricing function:

- the quote grid (strikes × maturities) prices in one broadcast evaluation
  (strikes and maturities ride a leading axis of the Heston parameters);
- the parameters are optimized unconstrained through smooth bijections
  (softplus for κ, θ, σ_v, v0; tanh for ρ), so no iterate leaves the
  admissible region;
- the steps are the port's Adam (``train/optimizers.py``, optax's
  constants, no clipping), with ``lr_stages`` as optax's piecewise-constant
  schedule: n_iter split into that many stages, each at a tenth of the
  last one's rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dnnpde_tpu_torch.numerics.heston import HestonParams, _prob
from dnnpde_tpu_torch.runtime import default_device

Tensor = torch.Tensor


def _softplus_inv(y: Tensor) -> Tensor:
    return y + torch.log(-torch.expm1(-y))


def _pack(kappa, theta, sigma, rho, v0, device) -> Tensor:
    """Constrained parameters → the unconstrained optimization vector."""
    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=device)

    return torch.stack([
        _softplus_inv(f32(kappa)), _softplus_inv(f32(theta)), _softplus_inv(f32(sigma)),
        torch.atanh(torch.clamp(f32(rho), -0.999, 0.999)), _softplus_inv(f32(v0)),
    ])


def _unpack(u: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    return F.softplus(u[0]), F.softplus(u[1]), F.softplus(u[2]), torch.tanh(u[3]), F.softplus(u[4])


class CalibrationResult(NamedTuple):
    params: HestonParams
    loss: float  # final mean squared relative price error
    rmse_rel: float  # sqrt(loss): the typical relative price misfit
    loss_history: np.ndarray  # (n_iter,)
    feller: float  # 2κθ − σ² (> 0: the variance stays positive)


def calibrate_heston(
    S0: float,
    strikes,
    maturities,
    market_prices,
    r: float,
    init: Optional[HestonParams] = None,
    n_iter: int = 400,
    lr: float = 0.05,
    order: int = 128,
    lr_stages: int = 1,
    device=None,
) -> CalibrationResult:
    """Fit Heston (κ, θ, σ_v, ρ, v0) to a quote grid by Adam on the exact
    differentiable closed form.

    ``strikes``/``maturities``/``market_prices``: same-length 1-D arrays,
    one entry per quote. ``r`` is held fixed. ``init`` defaults to the
    reference's parameter set. ``order``: Gauss–Legendre points per
    probability. ``lr_stages``: n_iter splits into this many equal stages,
    each at 10× smaller lr than the last (``n_iter=24_000, lr=0.05,
    lr_stages=3`` for a production fit: a single fixed-lr stage stalls in
    the flat (κ, ρ) valley). ``device``: None = the first CUDA card (raises
    without one); "cpu" fits on the CPU."""
    # imported here: train imports the solver, which imports numerics through pde
    from dnnpde_tpu_torch.train.optimizers import build_optimizer

    dev = default_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).reshape(-1)

    strikes, maturities, quotes = f32(strikes), f32(maturities), f32(market_prices)
    if not (strikes.shape == maturities.shape == quotes.shape):
        raise ValueError(
            "strikes, maturities and market_prices must be the same length; "
            f"got {tuple(strikes.shape)}, {tuple(maturities.shape)}, {tuple(quotes.shape)}")
    if lr_stages < 1:
        raise ValueError(f"lr_stages must be >= 1, got {lr_stages}")
    p0 = init or HestonParams()
    S = torch.full_like(quotes, float(S0))
    disc = torch.exp(-r * maturities)
    scale = torch.clamp(torch.abs(quotes), min=1e-6)

    def loss_fn(u: Tensor) -> Tensor:
        kappa, theta, sigma, rho, v0 = _unpack(u)
        hp = HestonParams(K=strikes[:, None], r=r, T=maturities[:, None], kappa=kappa,
                          theta=theta, sigma=sigma, rho=rho, v0=v0)
        model = S * _prob(hp, S, v0, 1, order) - strikes * disc * _prob(hp, S, v0, 2, order)
        return torch.mean(((model - quotes) / scale) ** 2)

    if lr_stages == 1:
        rate = lr
    else:
        bounds = [max(1, n_iter // lr_stages) * s for s in range(1, lr_stages)]

        def rate(count: Tensor) -> Tensor:
            value = torch.tensor(lr, dtype=torch.float32, device=count.device)
            for b in bounds:
                value = value * torch.where(count < b, 1.0, 0.1)
            return value

    tx = build_optimizer("Adam", rate, clip_norm=None)
    u = _pack(p0.kappa, p0.theta, p0.sigma, p0.rho, p0.v0, dev)
    state = tx.init([u])
    losses = []
    for _ in range(n_iter):
        u.requires_grad_(True)
        loss = loss_fn(u)
        (g,) = torch.autograd.grad(loss, u)
        with torch.no_grad():
            (update,), state = tx.update([g], state, [u])
            u = (u + update).detach()
        losses.append(loss.detach())
    with torch.no_grad():
        final = float(loss_fn(u))
        kappa, theta, sigma, rho, v0 = (float(x) for x in _unpack(u))
    return CalibrationResult(
        params=dataclasses.replace(p0, kappa=kappa, theta=theta, sigma=sigma, rho=rho, v0=v0),
        loss=final,
        rmse_rel=float(math.sqrt(final)),
        loss_history=(torch.stack(losses).cpu().numpy() if losses
                      else np.zeros(0, np.float32)),
        feller=2.0 * kappa * theta - sigma**2,
    )
