"""Longstaff–Schwartz Bermudan Monte-Carlo pricer on the solver's exact
Euler chain, the counterpart of ``dnnpde_tpu/numerics/longstaff_schwartz.py``:
a training-free oracle for the Bermudan-N value the reflected local
objective learns,

    V_n = max(g(X_n), E_n[V_{n+1}] / (1 + r·Δt)),   V_N = g(X_N),

under the same N-step Euler–Maruyama chain (μ, σ, ``sigma_dw``,
``post_step``, dtype) as the training rollout and the same per-step
(1 + rΔt) discounting. Works for any problem with a linear Z-free driver,
the American put under Heston dynamics included (no tree exists there).

Two passes (Longstaff & Schwartz 2001): a regression pass fits the
continuation value at each exercise date by weighted least squares of the
one-step-discounted cash flow on a polynomial basis of the state (plus the
payoff), in-the-money paths only; a pricing pass applies the frozen policy
to fresh paths. The paths are simulated on the device from a
``torch.Generator`` seeded by ``seed`` (the pricing pass by
``seed + 777_001``); the regression and pricing run on the host in
float64 numpy, as in the JAX package, so values agree with JAX's
statistically, not bit for bit.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from dnnpde_tpu_torch.numerics.discrete_bsde import euler_step, probe_linear_driver
from dnnpde_tpu_torch.runtime import default_device

Tensor = torch.Tensor


class LSMCValue(NamedTuple):
    """Two-pass Longstaff–Schwartz estimate of the Bermudan-N value."""

    value: float            # out-of-sample policy value (low-biased)
    standard_error: float   # MC error of the pricing pass
    in_sample_value: float  # regression-pass estimate (foresight-tinged)
    n_regression: int
    n_pricing: int
    N: int
    rate: float             # probed driver rate r of φ = r·Y
    # set when a cv_net was supplied (the neural control variate on the
    # stopped process); with a fitted coefficient (cv_c=None) ĉ is estimated
    # on the pricing paths it is applied to (an O(1/n_pricing) bias) and the
    # standard error omits its estimation variance; cv_c=1.0 is unbiased
    cv_variance_reduction: float = 1.0
    cv_c: float = 0.0
    plain_value: Optional[float] = None  # same paths, no control


def _normals(generator: torch.Generator, n: int, Dw: int, dtype) -> Tensor:
    """One step's standard normals (n, Dw) on the generator's device."""
    return torch.randn((n, Dw), generator=generator, dtype=dtype, device=generator.device)


def _simulate_paths(problem, N, n, seed, chol, dtype, x0=None, cv_net=None, rate=0.0,
                    device=None):
    """(N, n, D) stacked post-step states X_1..X_N of the solver's chain, on
    the host as float32 numpy, simulated on ``device`` from a generator
    seeded by ``seed``.

    With ``cv_net`` (a net module, evaluated through ``problem.transform_u``
    as in training), also returns the (N, n) per-step discounted martingale
    increments (1+rΔt)^{-(step+1)}·Z_θᵀσΔW at the pre-transition state, the
    stopped-process control variate, as float64 numpy."""
    from dnnpde_tpu_torch.solver.bsde import make_net_u

    device = default_device(device)
    D, Dw, T = problem.dim, problem.noise_dim, problem.T
    dt = T / N
    sqrt_dt = float(np.sqrt(dt))
    chol_T = None if chol is None else torch.as_tensor(chol, dtype=dtype).T.to(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    step_disc = ((1.0 + rate * dt) ** (-(np.arange(N) + 1.0))).astype(np.float32)
    net_u = None if cv_net is None else make_net_u(cv_net, transform=problem.transform_u)
    x0 = problem.x0 if x0 is None else x0
    X = torch.as_tensor(np.asarray(x0, np.float32), dtype=dtype).to(device).expand(n, D)
    Xs, Minc = [], []
    with torch.no_grad():
        for step_i in range(N):
            dw = sqrt_dt * _normals(gen, n, Dw, dtype)
            if chol_T is not None:
                dw = dw @ chol_T
            X1, sig = euler_step(problem, step_i, X, dw, dt)
            if net_u is not None:
                t0 = torch.full((n, 1), step_i * dt, dtype=dtype, device=device)
                _, Z = net_u(t0, X)
                Minc.append(float(step_disc[step_i]) * problem.z_sigma_dw(Z, sig, dw)[:, 0])
            X = X1
            Xs.append(X1)
    Xs = torch.stack(Xs).cpu().numpy().astype(np.float32)
    if net_u is None:
        return Xs, None
    return Xs, torch.stack(Minc).cpu().numpy().astype(np.float64)


_MAX_BASIS = 256  # hard cap on regressors — past this the normal equations
                  # are both slow and ill-conditioned; use basis="sorted"


def basis_size(D: int, degree: int, basis: str = "monomial",
               basis_top: int = 3) -> int:
    """Number of regressors ``_basis`` will build (incl. the payoff column).

    The full monomial basis is C(D+degree, degree) — combinatorial in D
    (D=10, degree=3 → 286); the "sorted" basis is C(k+degree, degree)+k−1
    with k = min(D, basis_top), CONSTANT in D.
    """
    k = D if basis == "monomial" else min(D, basis_top)
    from math import comb

    extra = 0 if basis == "monomial" else max(k - 1, 0)
    return comb(k + degree, degree) + 1 + extra


def _basis(X, g, degree, basis="monomial", basis_top=3):
    """Regression features at one exercise date, (n, B).

    - "monomial": monomials of total degree ≤ ``degree`` over ALL D state
      coords, plus the payoff itself (the classic LS extra regressor).
      Combinatorial in D — fine for small D.
    - "sorted": monomials of the TOP ``basis_top`` order statistics
      (coords sorted descending per sample) plus the payoff and the gaps
      between consecutive order stats. For exchangeable dynamics with a
      symmetric payoff (the Bermudan max-call family) the continuation
      value IS a symmetric function — i.e. a function of the order
      statistics — and the max payoff is driven by the leading ones, so
      this structured basis scales to any D at constant regressor count
      (Andersen–Broadie 2004 use the same idea for their max-call LSMC
      policies).
    """
    D = X.shape[1]
    if basis == "sorted":
        k = min(D, basis_top)
        Xs = -np.sort(-X, axis=1)[:, :k]  # descending order stats
        cols = [np.prod([Xs[:, d] ** p for d, p in enumerate(powers)],
                        axis=0)
                for powers in itertools.product(range(degree + 1), repeat=k)
                if sum(powers) <= degree]
        # gaps between consecutive order stats: where the max is contested
        # the continuation differs most from the single-asset picture
        cols.extend(Xs[:, d] - Xs[:, d + 1] for d in range(k - 1))
    elif basis == "monomial":
        cols = [np.prod([X[:, d] ** p for d, p in enumerate(powers)],
                        axis=0)
                for powers in itertools.product(range(degree + 1), repeat=D)
                if sum(powers) <= degree]
    else:
        raise ValueError(f"basis must be 'monomial' or 'sorted', got {basis!r}")
    cols.append(g)
    if len(cols) > _MAX_BASIS:
        raise ValueError(
            f"{len(cols)} regressors (D={D}, degree={degree}, "
            f"basis={basis!r}) exceeds the {_MAX_BASIS} cap — use "
            "basis='sorted' (constant in D) or a lower degree"
        )
    return np.stack(cols, axis=1)


def _fit(Phi, y, w, ridge=1e-8):
    """Weighted ridge normal equations in float64 with standardized
    features — conditioning beats raw lstsq with cubic terms."""
    Phi = Phi.astype(np.float64)
    mu = Phi.mean(axis=0)
    sd = Phi.std(axis=0)
    sd[sd < 1e-12] = 1.0
    Z = (Phi - mu) / sd
    Z[:, 0] = 1.0  # intercept column stays the intercept
    A = (Z * w[:, None]).T @ Z
    A[np.diag_indices_from(A)] += ridge * np.trace(A) / A.shape[0]
    b = (Z * w[:, None]).T @ y
    beta = np.linalg.solve(A, b)
    return beta, mu, sd


def _predict(Phi, fit):
    beta, mu, sd = fit
    Z = (Phi.astype(np.float64) - mu) / sd
    Z[:, 0] = 1.0
    return Z @ beta


def lsmc_value(
    problem,
    N: int,
    n_regression: int = 131_072,
    n_pricing: int = 262_144,
    degree: int = 3,
    seed: int = 0,
    chol=None,
    dtype=torch.float32,
    x0=None,
    cv_net: Optional[torch.nn.Module] = None,
    cv_c: Optional[float] = None,
    exercise_every: Optional[int] = None,
    basis: str = "monomial",
    basis_top: int = 3,
    device=None,
) -> LSMCValue:
    """Price the Bermudan-N contract of an ``early_exercise`` problem.

    Exercise dates are the solver grid t_1..t_N (the payoff at t_N is the
    terminal condition; immediate exercise at t = 0 is a final max with
    ``g(x0)``), the reflected local objective's recursion and the
    ``crr_binomial(..., exercise_every=·)`` convention. Applicability
    (linear Z-free driver, (Y, Z)-independent dynamics) is probed at run
    time. ``x0`` overrides the starting state.

    ``cv_net`` (the trained net module, e.g. ``Trainer.predict``'s choice of
    ``params`` or ``ema_params``; JAX takes ``(net_u, params)``) enables the
    neural control variate on the stopped process: the pricing-pass
    estimator becomes ``payoff_τ − c·m_τ`` with
    ``m_τ = Σ_{n<τ} (1+rΔt)^{-(n+1)} Z_θᵀσΔW_n``, unbiased for any θ by
    optional stopping. ``cv_c`` fixes the coefficient; None fits
    ĉ = Cov(pv, m_τ)/Var(m_τ) on the pricing paths.

    ``exercise_every`` restricts exercise to grid indices that are
    multiples of k (default: the problem's own); ``basis``/``basis_top``
    select the regression features (:func:`_basis`; "sorted" for symmetric
    multi-asset payoffs). Paths are simulated on ``device`` (None: the
    device of ``cv_net``, else the first CUDA card).
    """
    rate = probe_linear_driver(problem)
    if device is None and cv_net is not None:
        device = next(cv_net.parameters()).device
    dt = problem.T / N
    disc1 = 1.0 / (1.0 + rate * dt)
    k_ex = int(getattr(problem, "exercise_every", 1)
               if exercise_every is None else exercise_every)
    if N % k_ex:
        raise ValueError(
            f"N={N} must be a multiple of exercise_every={k_ex}"
        )

    def payoff(Xn):
        return problem.g(torch.from_numpy(np.asarray(Xn, np.float32))).numpy().astype(np.float64)[:, 0]

    # --- pass 1: regression ------------------------------------------------
    Xs, _ = _simulate_paths(problem, N, n_regression, seed, chol, dtype, x0,
                            device=device)
    CF = payoff(Xs[N - 1])  # value at t_N
    fits = [None] * N  # fits[n] = continuation fit at date t_n (1-indexed -1)
    min_itm = 16 * (degree + 2)
    for n in range(N - 1, 0, -1):  # dates t_{N-1} .. t_1
        y = CF * disc1  # one-step-discounted realized cash flow
        if n % k_ex:  # not an exercise date — pure discounting
            CF = y
            continue
        Xn = Xs[n - 1]
        g_n = payoff(Xn)
        itm = g_n > 0.0
        if itm.sum() >= min_itm:
            Phi = _basis(Xn.astype(np.float64), g_n, degree, basis,
                         basis_top)
            fit = _fit(Phi, y, itm.astype(np.float64))
            cont = _predict(Phi, fit)
            ex = itm & (g_n > cont)
            CF = np.where(ex, g_n, y)
            fits[n] = fit
        else:  # too few ITM paths to fit — never exercise at this date
            CF = y
    x0_row = np.asarray(problem.x0 if x0 is None else x0,
                        np.float64)[None, :]
    g0 = float(payoff(x0_row.astype(np.float32))[0])
    in_sample = max(g0, float(CF.mean() * disc1))

    # --- pass 2: fresh paths, frozen policy --------------------------------
    Xs, Minc = _simulate_paths(problem, N, n_pricing, seed + 777_001, chol,
                               dtype, x0, cv_net=cv_net, rate=rate, device=device)
    alive = np.ones(n_pricing, bool)
    pv = np.zeros(n_pricing, np.float64)
    tau = np.full(n_pricing, N, np.int64)  # exercise date (N = maturity)
    for n in range(1, N):
        if fits[n] is None:
            continue
        Xn = Xs[n - 1]
        g_n = payoff(Xn)
        Phi = _basis(Xn.astype(np.float64), g_n, degree, basis, basis_top)
        cont = _predict(Phi, fits[n])
        ex = alive & (g_n > 0.0) & (g_n > cont)
        pv[ex] = g_n[ex] * disc1**n
        tau[ex] = n
        alive &= ~ex
    g_N = payoff(Xs[N - 1])
    pv[alive] = g_N[alive] * disc1**N

    cv_vrf, plain_value = 1.0, None
    if Minc is None:
        cv_c = 0.0
    else:
        # m_τ = Σ_{n<τ} increments: exercise at date n uses the first n
        # increments (steps 0..n−1) — cumulative sum row τ−1
        Mcum = np.cumsum(Minc, axis=0)  # (N, n_pricing)
        m_tau = Mcum[tau - 1, np.arange(n_pricing)]
        var_p = pv.var()
        if cv_c is None:
            var_m = max(m_tau.var(), 1e-300)
            cov = np.cov(pv, m_tau, ddof=0)[0, 1]
            cv_c = float(cov / var_m)
        else:
            cv_c = float(cv_c)
        plain_value = max(g0, float(pv.mean()))
        pv = pv - cv_c * m_tau
        cv_vrf = float(var_p / max(pv.var(), 1e-300))
    value = max(g0, float(pv.mean()))
    se = float(pv.std() / np.sqrt(n_pricing))
    return LSMCValue(
        value=value,
        standard_error=se,
        in_sample_value=in_sample,
        n_regression=n_regression,
        n_pricing=n_pricing,
        N=N,
        rate=rate,
        cv_variance_reduction=cv_vrf,
        cv_c=cv_c,
        plain_value=plain_value,
    )
