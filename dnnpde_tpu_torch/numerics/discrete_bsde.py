"""Exact discrete-N BSDE value for linear drivers, by forward Monte Carlo:
the counterpart of ``dnnpde_tpu/numerics/discrete_bsde.py``.

For a driver linear in Y with no Z-coupling, φ(t, X, Y, Z) = r·Y, and
dynamics μ/σ independent of (Y, Z), the solver's explicit Euler recursion
Ỹ_{n+1} = Y_n·(1 + rΔt) + Z_nᵀσΔW_n telescopes under conditional
expectation, so the value at t = 0 is

    D(N) = E[g(X_N)] / (1 + r·Δt)^N

with X_N from the same N-step Euler–Maruyama chain (μ, σ, ``sigma_dw``,
``post_step``, dtype) the training rollout simulates: the exact value a
perfectly trained Y0 hits at resolution N, computed with no training.
Applicability is probed numerically (:func:`probe_linear_driver`): BSB
(φ = r(Y − X·Z)) and HJB (φ = ‖Z‖²) are refused.

The paths run in batches on the device; each step's increments are drawn
from one ``torch.Generator`` seeded by ``seed``, so the values agree with
the JAX package's statistically, not bit for bit. The chain itself,
:func:`euler_terminal_states`, takes its increments as an argument; its
step, :func:`euler_step`, is the one that the control variate, the
Longstaff–Schwartz paths and the policy value also take.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from dnnpde_tpu_torch.runtime import default_device

Tensor = torch.Tensor


class DiscreteBSDEValue(NamedTuple):
    """MC estimate of the exact discrete-N BSDE value."""

    value: float
    standard_error: float
    n_paths: int
    N: int
    rate: float


def probe_linear_driver(problem, atol: float = 1e-5) -> float:
    """Return the driver rate r of φ = r·Y, or raise if the problem does not
    have a linear Z-free driver with (Y, Z)-independent dynamics.

    Purely numeric, in float32 on the CPU: φ/μ/σ are evaluated at probe
    states X = x0·(1 ± 10 %) with varying (Y, Z) and checked for
    φ(Y=0) = 0, φ(Y) = r·Y (the same r at Y = 1 and Y = 2, uniform across
    X), φ independent of Z, and μ/σ independent of (Y, Z).
    """
    D = problem.dim
    x0 = np.asarray(problem.x0, np.float64).reshape(1, D)
    X = torch.as_tensor(
        np.concatenate([x0, x0 * 1.1, np.maximum(x0 * 0.9, 1e-3)], axis=0), dtype=torch.float32
    )
    t = torch.full((3, 1), 0.3, dtype=torch.float32)
    Y0, Y1, Y2 = (torch.full((3, 1), v, dtype=torch.float32) for v in (0.0, 1.0, 2.0))
    Z0 = torch.zeros((3, D), dtype=torch.float32)
    Z1 = torch.ones((3, D), dtype=torch.float32) * 0.7

    def arr(a):
        return np.asarray(a.detach().cpu(), np.float64)

    name = getattr(problem, "name", type(problem).__name__)
    phi0 = arr(problem.phi(t, X, Y0, Z0))
    if not np.allclose(phi0, 0.0, atol=atol):
        raise ValueError(
            f"{name}: driver has a constant term (φ(Y=0) = {phi0.ravel()}) — "
            "discrete_bsde_value requires φ = r·Y"
        )
    phi1 = arr(problem.phi(t, X, Y1, Z0))
    phi2 = arr(problem.phi(t, X, Y2, Z0))
    if not np.allclose(phi2, 2.0 * phi1, atol=atol):
        raise ValueError(
            f"{name}: driver is not linear in Y (φ(2)={phi2.ravel()} vs "
            f"2·φ(1)={2 * phi1.ravel()})"
        )
    rate = float(phi1.mean())
    if not np.allclose(phi1, rate, atol=atol):
        raise ValueError(
            f"{name}: driver rate varies with the state ({phi1.ravel()}) — "
            "φ must be r·Y with constant r"
        )
    if not np.allclose(arr(problem.phi(t, X, Y1, Z1)), phi1, atol=atol):
        raise ValueError(
            f"{name}: driver depends on Z — the martingale term no longer "
            "telescopes; discrete_bsde_value does not apply"
        )
    if not np.allclose(arr(problem.mu(t, X, Y2, Z1)), arr(problem.mu(t, X, Y0, Z0)), atol=atol):
        raise ValueError(f"{name}: mu depends on (Y, Z)")
    if not np.allclose(arr(problem.sigma(t, X, Y2)), arr(problem.sigma(t, X, Y0)), atol=atol):
        raise ValueError(f"{name}: sigma depends on Y")
    return rate


def euler_step(problem, step: int, X: Tensor, dw: Tensor, dt: float) -> tuple[Tensor, Tensor]:
    """One transition of the solver's Euler chain (``solver/bsde.py::em_step``
    with (Y, Z) = 0, which the probed dynamics do not read) from grid index
    ``step``, then ``post_step`` at the next grid time, as in the training
    rollout. ``dw`` (n, Dw) is the step's (correlated) increment. Returns
    X at ``step + 1`` and σ(t_step, X), which a martingale term reads."""
    n = X.shape[0]
    t0 = torch.full((n, 1), step * dt, dtype=X.dtype, device=X.device)
    Yz = X.new_zeros((n, 1))
    sig = problem.sigma(t0, X, Yz)
    X1 = X + problem.mu(t0, X, Yz, torch.zeros_like(X)) * dt + problem.sigma_dw(sig, dw)
    if problem.has_post_step:
        t1 = torch.full((n, 1), (step + 1) * dt, dtype=X.dtype, device=X.device)
        X1 = problem.post_step(t1, X1)
    return X1, sig


def euler_terminal_states(problem, X0: Tensor, increments: Iterable[Tensor], N: int,
                          chol_T: Optional[Tensor] = None) -> Tensor:
    """X_N of the solver's Euler chain (:func:`euler_step`, N times) from X0
    (n, D).

    ``increments`` yields the N per-step Brownian increments (n, Dw), e.g. a
    (N, n, Dw) tensor; ``chol_T`` (Dw, Dw), when given, correlates each one
    as ``dw @ chol_T``."""
    dt = problem.T / N
    X = X0
    for step, dw in zip(range(N), increments):
        if chol_T is not None:
            dw = dw @ chol_T
        X, _ = euler_step(problem, step, X, dw, dt)
    return X


def _step_increments(generator: torch.Generator, N: int, batch: int, Dw: int, dt: float,
                     dtype, antithetic: bool):
    """The N per-step increments (batch, Dw) of one batch, drawn one step at
    a time (memory O(batch·Dw) for any N); under ``antithetic`` the first
    half of the batch is mirrored into the second."""
    sqrt_dt = float(np.sqrt(dt))
    for _ in range(N):
        if antithetic:
            half = torch.randn((batch // 2, Dw), generator=generator, dtype=dtype,
                               device=generator.device)
            yield sqrt_dt * torch.cat([half, -half], dim=0)
        else:
            yield sqrt_dt * torch.randn((batch, Dw), generator=generator, dtype=dtype,
                                        device=generator.device)


def discrete_bsde_value(
    problem,
    N: int,
    n_paths: int = 1_000_000,
    seed: int = 0,
    batch: int = 262_144,
    chol=None,
    dtype=torch.float32,
    antithetic: bool = True,
    x0=None,
    device=None,
) -> DiscreteBSDEValue:
    """MC-estimate D(N) = E[g(X_N)]/(1+r·Δt)^N under the solver's Euler chain.

    ``chol`` must match the Trainer's correlation Cholesky factor (None for
    the identity). ``antithetic`` pairs (dW, −dW); its standard error is
    that of the pair means, the i.i.d. units. ``x0`` overrides the starting
    state (default ``problem.x0``). Paths run on ``device`` (None: the first
    CUDA card), ``batch`` at a time."""
    rate = probe_linear_driver(problem)
    return _discrete_value(problem, rate, N, problem.x0 if x0 is None else x0, n_paths, seed,
                           batch, chol, dtype, antithetic, default_device(device))


def _discrete_value(problem, rate, N, x0, n_paths, seed, batch, chol, dtype, antithetic,
                    device) -> DiscreteBSDEValue:
    D, Dw, T = problem.dim, problem.noise_dim, problem.T
    dt = T / N
    batch = min(batch, n_paths)
    if antithetic and batch % 2:
        batch += 1
    n_batches = max(1, int(np.ceil(n_paths / batch)))
    chol_T = None if chol is None else torch.as_tensor(np.asarray(chol), dtype=dtype).T.to(device)
    X0 = torch.as_tensor(np.asarray(x0, np.float32), dtype=dtype).to(device).expand(batch, D)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = torch.zeros((), dtype=torch.float64, device=device)
    total_sq = torch.zeros((), dtype=torch.float64, device=device)
    with torch.no_grad():
        for _ in range(n_batches):
            incs = _step_increments(gen, N, batch, Dw, dt, dtype, antithetic)
            pay = problem.g(euler_terminal_states(problem, X0, incs, N, chol_T))[:, 0]
            pay = pay.double()
            if antithetic:
                # the i.i.d. units are the pair means (g(W) + g(−W))/2; pooling
                # the payoffs would report the plain-MC error and hide the
                # pair covariance that antithetic sampling buys
                pay = 0.5 * (pay[: batch // 2] + pay[batch // 2:])
            total += pay.sum()
            total_sq += (pay * pay).sum()
    n_units = n_batches * (batch // 2 if antithetic else batch)
    mean = float(total) / n_units
    var = max(float(total_sq) / n_units - mean * mean, 0.0)
    disc = float((1.0 + rate * dt) ** (-N))
    return DiscreteBSDEValue(
        value=disc * mean,
        standard_error=disc * float(np.sqrt(var / n_units)),
        n_paths=n_batches * batch,
        N=N,
        rate=rate,
    )


def discrete_bsde_surface(
    problem,
    N: int,
    x0s,
    n_paths: int = 1_000_000,
    seed: int = 0,
    batch: int = 262_144,
    chol=None,
    dtype=torch.float32,
    antithetic: bool = True,
    device=None,
) -> list[DiscreteBSDEValue]:
    """D(N; x0) over a grid of initial states ``x0s`` (K, D): one
    :class:`DiscreteBSDEValue` per state, state i on its own stream
    (seed + 1000·i), as the JAX package keys them."""
    rate = probe_linear_driver(problem)
    x0s = np.asarray(x0s, np.float32)
    if x0s.ndim != 2 or x0s.shape[1] != problem.dim:
        raise ValueError(f"x0s must be (K, {problem.dim}), got {x0s.shape}")
    device = default_device(device)
    return [
        _discrete_value(problem, rate, N, x0s[i], n_paths, seed + 1000 * i, batch, chol,
                        dtype, antithetic, device)
        for i in range(x0s.shape[0])
    ]
