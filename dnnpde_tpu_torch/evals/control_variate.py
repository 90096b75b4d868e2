"""Neural control-variate pricing, the counterpart of
``dnnpde_tpu/evals/control_variate.py``: the trained net as a variance
killer for the Monte-Carlo price of the discrete-N value
D(N) = E[g(X_N)]/(1+rΔt)^N (``numerics/discrete_bsde.py``).

Along the solver's Euler chain the martingale

    m  =  Σ_{n=0}^{N-1} (1+rΔt)^{-(n+1)} · Z_θ(t_n, X_n)ᵀ σ(t_n, X_n) ΔW_n

has E[m] = 0 exactly for any parameters θ (each ΔW_n is independent of
Z_θ(t_n, X_n)). When the net is accurate, discounted payoff ≈ Y0 + m
pathwise, so the estimator

    D̂ = mean(payoff) − c · mean(m),   c = Cov(payoff, m)/Var(m)

stays unbiased (up to the O(1/n) same-sample ĉ term; ``c=1.0`` is strictly
unbiased) while dividing the variance by ``variance_reduction``.
Applicability matches the discrete oracle (linear Z-free driver, probed at
run time); the path-dependent ``post_step`` chains are supported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dnnpde_tpu_torch.numerics.discrete_bsde import (
    _step_increments,
    euler_step,
    probe_linear_driver,
)
from dnnpde_tpu_torch.runtime import default_device


class NeuralCVValue(NamedTuple):
    """Control-variate MC estimate of the discrete-N value D(N)."""

    value: float               # mean(payoff) − c·mean(m)
    standard_error: float      # SE of the residual payoff − c·m
    plain_value: float         # mean(payoff): same paths, no control
    plain_standard_error: float
    variance_reduction: float  # Var(payoff) / Var(payoff − c·m)
    c: float                   # fitted control coefficient (≈1 for a good net)
    martingale_mean: float     # mean(m): should sit within its own SE of 0
    n_paths: int
    N: int
    rate: float                # probed driver rate r of φ = r·Y


def neural_cv_value(
    problem,
    net_u: Callable,
    N: int,
    n_paths: int = 1_000_000,
    seed: int = 0,
    batch: int = 131_072,
    chol=None,
    dtype=torch.float32,
    x0=None,
    c: Optional[float] = None,
    device=None,
) -> NeuralCVValue:
    """Price D(N) by forward MC with the trained net as control variate.

    ``net_u(t, X) → (u, Z)`` is the training-identical callable
    (``Trainer.net_u``, ``solver.make_net_u(module, transform=
    problem.transform_u)``: the output transform is inside it, so Z is the
    transformed gradient exactly as trained; the JAX function takes
    ``(net_u, params)``). The chain is the solver's Euler step with
    ``post_step``, so the estimator targets the same D(N) as
    ``numerics.discrete_bsde_value``. Paths are drawn from a generator
    seeded by ``seed`` on ``device`` (None: the first CUDA card), ``batch``
    at a time.

    ``c=None`` fits the coefficient from the pooled sample moments;
    ``c=1.0`` is the strictly unbiased estimator.
    """
    if getattr(problem, "early_exercise", False):
        raise ValueError(
            f"{getattr(problem, 'name', type(problem).__name__)}: the "
            "telescoped estimator targets the EUROPEAN discrete value "
            "D(N) and would silently ignore early exercise — price "
            "optimal-stopping contracts with numerics.lsmc_value("
            "cv_net=…) instead (the same control variate, applied to "
            "the stopped process)"
        )
    rate = probe_linear_driver(problem)
    device = default_device(device)
    D, Dw, T = problem.dim, problem.noise_dim, problem.T
    dt = T / N
    batch = min(batch, n_paths)
    n_batches = max(1, int(np.ceil(n_paths / batch)))
    chol_T = None if chol is None else torch.as_tensor(np.asarray(chol), dtype=dtype).T.to(device)
    X0 = torch.as_tensor(np.asarray(problem.x0 if x0 is None else x0, np.float32),
                         dtype=dtype).to(device).expand(batch, D)
    # per-step discounts (1+rΔt)^{-(n+1)}, n = 0..N−1, and the terminal one
    step_disc = ((1.0 + rate * dt) ** (-(np.arange(N) + 1.0))).astype(np.float32)
    disc_N = float((1.0 + rate * dt) ** (-N))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sums = torch.zeros(5, dtype=torch.float64, device=device)
    with torch.no_grad():
        for _ in range(n_batches):
            X = X0
            m = torch.zeros((batch,), dtype=dtype, device=device)
            incs = _step_increments(gen, N, batch, Dw, dt, dtype, antithetic=False)
            for step, dw in enumerate(incs):
                if chol_T is not None:
                    dw = dw @ chol_T
                t0 = torch.full((batch, 1), step * dt, dtype=dtype, device=device)
                _, Z = net_u(t0, X)
                X1, sig = euler_step(problem, step, X, dw, dt)
                m = m + float(step_disc[step]) * problem.z_sigma_dw(Z, sig, dw)[:, 0]
                X = X1
            p = (disc_N * problem.g(X)[:, 0]).double()
            m = m.double()
            # pooled second moments: the host combines batches exactly
            sums += torch.stack([p.sum(), (p * p).sum(), m.sum(), (m * m).sum(), (p * m).sum()])
    n = n_batches * batch
    sp, spp, sm, smm, spm = sums.cpu().numpy()
    mean_p, mean_m = sp / n, sm / n
    var_p = max(spp / n - mean_p**2, 0.0)
    var_m = max(smm / n - mean_m**2, 1e-300)
    cov = spm / n - mean_p * mean_m
    c_fit = cov / var_m if c is None else float(c)
    var_resid = max(var_p - 2.0 * c_fit * cov + c_fit**2 * var_m, 0.0)
    return NeuralCVValue(
        value=float(mean_p - c_fit * mean_m),
        standard_error=float(np.sqrt(var_resid / n)),
        plain_value=float(mean_p),
        plain_standard_error=float(np.sqrt(var_p / n)),
        variance_reduction=float(var_p / max(var_resid, 1e-300)),
        c=float(c_fit),
        martingale_mean=float(mean_m),
        n_paths=n,
        N=N,
        rate=rate,
    )


def neural_cv_from_trainer(
    trainer, N: Optional[int] = None, use_ema: bool = True, **kwargs
) -> NeuralCVValue:
    """Price with a trained ``Trainer``'s net: its own time grid N and, by
    default, the EMA shadow (the serving read), on the trainer's device.
    Extra kwargs pass through to :func:`neural_cv_value`."""
    from dnnpde_tpu_torch.solver.bsde import make_net_u

    net = trainer.ema_params if use_ema else trainer.params
    net_u = make_net_u(net, transform=trainer.problem.transform_u)
    kwargs.setdefault("device", trainer.device)
    return neural_cv_value(trainer.problem, net_u, trainer.N if N is None else N, **kwargs)
