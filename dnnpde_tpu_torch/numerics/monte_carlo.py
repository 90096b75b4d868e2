"""Monte-Carlo pricers, the counterpart of ``dnnpde_tpu/numerics/monte_carlo.py``.

A ``torch.Generator`` takes the place of the JAX key, and the computation
runs on the generator's device: a CPU generator is the caller asking for the
CPU. Every pricer returns (value, standard error) as 0-d tensors where the
JAX package does, so tolerances can be stated in standard errors.
"""

from __future__ import annotations

from typing import Optional

import torch

from dnnpde_tpu_torch.sim.euler_maruyama import gbm_paths

Tensor = torch.Tensor


def basket_call_payoff(
    ST: Tensor, K: float, r: float, T: float, payoff: str = "mean", weights=None
) -> tuple[Tensor, Tensor]:
    """Discounted basket-call price and standard error from terminal values
    ST (n, D): (e^{−rT}·mean(pay), e^{−rT}·std(pay)/√n) with pay =
    max(agg(ST) − K, 0) and std with divisor n, as ``jnp.std``. ``payoff``
    is "mean", "sum" or "weighted" (``weights``)."""
    if payoff == "mean":
        basket = torch.mean(ST, dim=-1)
    elif payoff == "sum":
        basket = torch.sum(ST, dim=-1)
    elif payoff == "weighted":
        basket = ST @ torch.as_tensor(weights, dtype=torch.float32).to(ST.device)
    else:
        raise ValueError(f"unknown payoff {payoff!r}")
    pay = torch.clamp(basket - K, min=0.0)
    disc = torch.exp(torch.tensor(-r * T, dtype=torch.float32, device=pay.device))
    price = disc * torch.mean(pay)
    se = disc * torch.std(pay, correction=0) / pay.shape[0] ** 0.5
    return price, se


def basket_call_mc(
    generator: torch.Generator,
    S0,
    K: float,
    T: float,
    r: float,
    sigma,
    chol: Optional[Tensor] = None,
    weights=None,
    num_paths: int = 100_000,
    num_steps: int = 1,
    antithetic: bool = True,
    payoff: str = "mean",
    drift: Optional[float] = None,
) -> tuple[Tensor, Tensor]:
    """Discounted basket-call price E[e^{−rT} max(agg(S_T) − K, 0)] and its
    standard error.

    ``drift`` decouples the simulation drift from the discount rate ``r``
    (default: equal), e.g. for CallOptionND's drift-2r semantics.
    ``payoff``: "mean" (equal-weight mean basket), "weighted" (``weights``)
    or "sum" (ΣS). GBM terminal values are exact-scheme, so
    ``num_steps=1`` suffices for European payoffs.
    """
    mu = r if drift is None else drift
    paths = gbm_paths(generator, S0, mu, sigma, T, num_steps, num_paths, chol, antithetic)
    return basket_call_payoff(paths[:, -1, :], K, r, T, payoff, weights)


def basket_delta_mc(
    generator: torch.Generator,
    S0,
    K: float,
    T: float,
    r: float,
    sigma,
    chol: Optional[Tensor] = None,
    bump: float = 0.01,
    num_paths: int = 100_000,
    payoff: str = "mean",
) -> Tensor:
    """Bump-and-revalue per-asset deltas with common random numbers: every
    bumped pricing restarts from the generator's state at the call, as the
    JAX package reuses one key. Returns (D,) deltas; the generator is left
    where the last pricing left it."""
    S0 = torch.atleast_1d(torch.as_tensor(S0, dtype=torch.float32)).to(generator.device)
    D = S0.shape[0]
    state = generator.get_state()

    def price_at(s0_vec):
        generator.set_state(state)
        p, _ = basket_call_mc(
            generator, s0_vec, K, T, r, sigma, chol, num_paths=num_paths, payoff=payoff,
        )
        return p

    deltas = []
    for d in range(D):
        e = torch.zeros(D, device=S0.device)
        e[d] = bump
        deltas.append((price_at(S0 + e) - price_at(S0 - e)) / (2 * bump))
    return torch.stack(deltas)


def basket_price_paths_mc(
    generator: torch.Generator,
    S0,
    K: float,
    T: float,
    r: float,
    sigma,
    N: int,
    chol: Optional[Tensor] = None,
    num_paths: int = 10_000,
    payoff: str = "mean",
) -> tuple[Tensor, Tensor]:
    """Price process along the time grid: at each step n the path average
    of the discounted intrinsic value of the forward-grown basket.

    Returns (t_grid (N+1,), price path (N+1,)).
    """
    paths = gbm_paths(generator, S0, r, sigma, T, N, num_paths, chol)
    t = torch.linspace(0.0, T, N + 1, device=paths.device)
    basket = torch.mean(paths, dim=-1) if payoff == "mean" else torch.sum(paths, dim=-1)
    tau = T - t
    grown = basket * torch.exp(r * tau)[None, :]
    intrinsic_path = torch.exp(-r * tau)[None, :] * torch.clamp(grown - K, min=0.0)
    return t, torch.mean(intrinsic_path, dim=0)


def hjb_exact_mc(
    generator: torch.Generator,
    t: float,
    x,
    T: float = 1.0,
    num_samples: int = 100_000,
) -> Tensor:
    """HJB closed form by Monte Carlo: u(t,x) = −log E[exp(−g(x + √(2(T−t))·W))]
    with g(y) = log(½ + ½‖y‖²)."""
    device = generator.device
    x = torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32)).to(device)
    D = x.shape[-1]
    W = torch.randn((num_samples, D), generator=generator, device=device)
    y = x[None, :] + (2.0 * max(T - t, 0.0)) ** 0.5 * W
    g = torch.log(0.5 + 0.5 * torch.sum(y**2, dim=-1))
    return -torch.log(torch.mean(torch.exp(-g)))
