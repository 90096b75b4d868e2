"""Applicability probe of the discrete-BSDE oracles, the part of
``dnnpde_tpu/numerics/discrete_bsde.py`` ported so far (the value
estimators themselves are listed in ROADMAP.md, Queue 1).

For a driver linear in Y with no Z-coupling, φ(t, X, Y, Z) = r·Y, and
dynamics μ/σ independent of (Y, Z), the solver's explicit Euler recursion
Ỹ_{n+1} = Y_n·(1 + rΔt) + Z_nᵀσΔW_n telescopes under conditional
expectation; the Longstaff–Schwartz and policy-value oracles rely on that.
"""

from __future__ import annotations

import numpy as np
import torch


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
