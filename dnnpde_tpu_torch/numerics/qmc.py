"""Randomized quasi-Monte Carlo (Owen-scrambled Sobol) oracle pricing, the
counterpart of ``dnnpde_tpu/numerics/qmc.py``.

- Sobol points (scipy's direction numbers, up to 21201 dimensions) replace
  pseudo-random draws; smooth integrands converge near n^{-1}.
- Owen scrambling keeps every replicate an unbiased estimator, so R
  independent scrambles give the value (mean of replicate means) and an
  honest standard error (spread of replicate means / √R).
- Brownian-bridge ordering maps the best-equidistributed leading Sobol
  coordinates onto the path's coarsest structure (W_T first, then
  midpoints, recursively).

The points come from ``scipy.stats.qmc`` on the host, as in the JAX package,
so for the same seed the increments are the JAX package's up to float32
rounding. Only the chain (``discrete_bsde.euler_terminal_states``: the
solver's μ, σ, ``sigma_dw``, ``post_step``, dtype) runs on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dnnpde_tpu_torch.numerics.discrete_bsde import euler_terminal_states, probe_linear_driver
from dnnpde_tpu_torch.runtime import default_device

# scipy's Joe–Kuo direction numbers end here; beyond it QMC cannot be used.
_SOBOL_MAX_DIM = 21201


def brownian_bridge_order(N: int) -> np.ndarray:
    """Time-step visitation order for the Brownian-bridge construction: a
    permutation of {0, …, N−1} (grid indices of t_1 … t_N) with
    ``order[0] = N−1`` (the terminal point), then recursively the midpoint
    of each longest unresolved span (Caflisch–Morokoff–Owen)."""
    order = [N - 1]
    spans = [(-1, N - 1)]  # (known left grid index, known right grid index)
    while spans:
        nxt = []
        for lo, hi in spans:
            if hi - lo <= 1:
                continue
            mid = (lo + hi) // 2
            order.append(mid)
            nxt.append((lo, mid))
            nxt.append((mid, hi))
        spans = nxt
    return np.asarray(order, np.int64)


def _bridge_paths(z_bridge: np.ndarray, N: int, dtype) -> np.ndarray:
    """Standardized Brownian paths W(t_k)/√dt from bridge normals
    ``z_bridge`` (n, N, Dw) in bridge order (column k is the normal consumed
    at the k-th visit of :func:`brownian_bridge_order`'s span walk). Returns
    W at grid indices 0…N−1 in units of √dt."""
    n, _, Dw = z_bridge.shape
    W = np.empty((n, N, Dw), dtype)
    W[:, N - 1] = np.sqrt(float(N)) * z_bridge[:, 0]
    col = 1
    pend = [(-1, N - 1)]
    while pend:
        nxt = []
        for lo, hi in pend:
            if hi - lo <= 1:
                continue
            mid = (lo + hi) // 2
            Wlo = 0.0 if lo < 0 else W[:, lo]
            Whi = W[:, hi]
            a = float(mid - lo)
            b = float(hi - mid)
            mean = (b * Wlo + a * Whi) / (a + b)
            std = np.sqrt(a * b / (a + b))
            W[:, mid] = mean + std * z_bridge[:, col]
            col += 1
            nxt.append((lo, mid))
            nxt.append((mid, hi))
        pend = nxt
    return W


def sobol_brownian_increments(
    n: int,
    N: int,
    Dw: int,
    dt: float,
    seed: int = 0,
    dtype=np.float32,
    bridge: bool = True,
) -> np.ndarray:
    """(n, N, Dw) Brownian increments from one Owen-scrambled Sobol stream,
    as numpy on the host.

    ``bridge=True`` applies the Brownian-bridge ordering; ``bridge=False``
    maps Sobol coordinates to steps in time order. ``n`` is rounded up to
    the next power of two and the full 2^m point set is returned: truncating
    a Sobol sequence off a power of two destroys its balance."""
    dim = N * Dw
    if dim > _SOBOL_MAX_DIM:
        raise ValueError(
            f"QMC dimension N*Dw = {dim} exceeds the Sobol table "
            f"({_SOBOL_MAX_DIM}); use the pseudo-random oracle"
        )
    m = int(np.ceil(np.log2(max(n, 2))))
    n = 1 << m
    from scipy.stats import norm as _norm, qmc as _qmc  # scipy.stats takes seconds to load

    eng = _qmc.Sobol(d=dim, scramble=True, seed=seed)
    u = eng.random_base2(m)
    # scrambling keeps points in (0, 1) almost surely; clip for ppf safety
    z = _norm.ppf(np.clip(u, 1e-12, 1.0 - 1e-12)).astype(np.float64)
    # coordinate k*Dw+j → bridge position k, noise dim j
    z = z.reshape(n, N, Dw)
    sqrt_dt = np.sqrt(dt)
    if not bridge:
        return (sqrt_dt * z).astype(dtype)
    W = _bridge_paths(z, N, np.float64)
    dW = np.empty_like(W)
    dW[:, 0] = W[:, 0]
    dW[:, 1:] = W[:, 1:] - W[:, :-1]
    return (sqrt_dt * dW).astype(dtype)


class QMCValue(NamedTuple):
    """Randomized-QMC estimate with an honest (replicate-spread) SE."""

    value: float
    standard_error: float
    n_paths: int
    n_replicates: int
    N: int
    rate: float


def _make_chain(problem, N, batch, chol, dtype, device):
    """(x0, dW (batch, N, Dw) on the device) → Σ g(X_N) as a 0-d float64
    tensor; the discount is left to the caller."""
    D = problem.dim
    chol_T = None if chol is None else torch.as_tensor(np.asarray(chol), dtype=dtype).T.to(device)

    def run(x0, dWs):
        X0 = torch.as_tensor(x0, dtype=dtype, device=device).reshape(1, D).expand(batch, D)
        with torch.no_grad():
            XN = euler_terminal_states(problem, X0, dWs.transpose(0, 1), N, chol_T)
            return problem.g(XN)[:, 0].double().sum()

    return run


def discrete_bsde_value_qmc(
    problem,
    N: int,
    n_paths: int = 65_536,
    n_replicates: int = 16,
    seed: int = 0,
    chol=None,
    dtype=torch.float32,
    x0=None,
    bridge: bool = True,
    device=None,
) -> QMCValue:
    """Randomized-QMC D(N) = E[g(X_N)]/(1+r·Δt)^N on the solver's chain:
    ``n_replicates`` independent Owen scrambles (seeds seed + 7919·r, as in
    the JAX package) of ``n_paths`` Sobol points each (rounded up to a power
    of two). Same value as ``discrete_bsde_value``, at a far smaller SE per
    path; the SE is the replicate spread. The chain runs on ``device``
    (None: the first CUDA card)."""
    rate = probe_linear_driver(problem)
    device = default_device(device)
    Dw, T = problem.noise_dim, problem.T
    dt = T / N
    n = 1 << int(np.ceil(np.log2(max(n_paths, 2))))
    fn = _make_chain(problem, N, n, chol, dtype, device)
    x0 = np.asarray(problem.x0 if x0 is None else x0, np.float32)
    # increments at the chain's own precision
    inc_dtype = torch.empty((), dtype=dtype).numpy().dtype
    means = np.empty(n_replicates, np.float64)
    for r in range(n_replicates):
        dW = sobol_brownian_increments(n, N, Dw, dt, seed=seed + 7919 * r, dtype=inc_dtype,
                                       bridge=bridge)
        means[r] = float(fn(x0, torch.from_numpy(dW).to(device))) / n
    disc = float((1.0 + rate * dt) ** (-N))
    return QMCValue(
        value=disc * float(means.mean()),
        standard_error=disc * float(means.std(ddof=1) / np.sqrt(n_replicates)),
        n_paths=n * n_replicates,
        n_replicates=n_replicates,
        N=N,
        rate=rate,
    )
