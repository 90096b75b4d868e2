"""Policy-value read for optimal-stopping nets, the counterpart of
``dnnpde_tpu/evals/policy_value.py``: the net is used only as an exercise
policy on fresh paths,

    stop at the first exercise date with  g(X_n) > u_θ(t_n, X_n),

and the discounted payoff at the stop is averaged. For any policy this is
an exact lower bound on the true value, and a first-order-accurate one (an
O(ε) error in the exercise boundary costs O(ε²) in value), so it removes the
max-bootstrap bias of the direct read ``max(g(x0), u_θ(0, x0))``; the
published Bermudan benchmark values are policy values too.

The chain is the solver's (Euler step, ``post_step``, per-step discount
(1+rΔt)⁻¹). Each batch is simulated and decided on the device; the host
reads only each batch's centred moments and pools them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dnnpde_tpu_torch.numerics.discrete_bsde import euler_step, probe_linear_driver
from dnnpde_tpu_torch.numerics.longstaff_schwartz import _normals
from dnnpde_tpu_torch.runtime import default_device


class PolicyValue(NamedTuple):
    """Fresh-path lower-bound estimate from the net's exercise policy."""

    value: float            # mean discounted payoff at the policy's stop
    standard_error: float
    n_paths: int
    N: int
    rate: float             # probed driver rate r of φ = r·Y
    exercise_fraction: float  # paths stopped strictly before maturity
    immediate: bool         # True when g(x0) beat the simulated value


def _net_device(net, device):
    if device is None:
        p = next(iter(net.parameters()), None) if net is not None else None
        if p is not None:
            return p.device
    return default_device(device)


def policy_value(
    problem,
    net: torch.nn.Module,
    N: int,
    n_paths: int = 1_048_576,
    seed: int = 0,
    batch: int = 262_144,
    chol=None,
    dtype=torch.float32,
    x0=None,
    exercise_every: Optional[int] = None,
    device=None,
) -> PolicyValue:
    """Price the Bermudan contract by running the net's stopping rule.

    ``net`` is the trained module (JAX takes ``(net_u, params)``); its u
    through ``problem.transform_u`` is the training-identical continuation
    value of an ``early_exercise`` problem. Exercise is restricted to grid
    indices that are multiples of ``exercise_every`` (default: the
    problem's own), maturity always pays ``g(X_N)``, and immediate exercise
    at t = 0 is the final ``max(g(x0), ·)`` read, flagged in ``immediate``.
    Paths are drawn from a generator seeded by ``seed`` on ``device`` (None:
    the net's device).
    """
    if not getattr(problem, "early_exercise", False):
        raise ValueError(
            f"{getattr(problem, 'name', type(problem).__name__)}: "
            "policy_value prices optimal-stopping contracts; for "
            "European-style problems the telescoped estimator "
            "(evals.neural_cv_value / numerics.discrete_bsde_value) "
            "is the right tool"
        )
    rate = probe_linear_driver(problem)
    device = _net_device(net, device)
    D, Dw, T = problem.dim, problem.noise_dim, problem.T
    dt = T / N
    sqrt_dt = float(np.sqrt(dt))
    k_ex = int(getattr(problem, "exercise_every", 1) if exercise_every is None else exercise_every)
    if N % k_ex:
        raise ValueError(f"N={N} must be a multiple of exercise_every={k_ex}")
    batch = min(batch, n_paths)
    n_batches = max(1, int(np.ceil(n_paths / batch)))
    chol_T = None if chol is None else torch.as_tensor(chol, dtype=dtype).T.to(device)
    x0 = torch.as_tensor(np.asarray(problem.x0 if x0 is None else x0, np.float32),
                         dtype=dtype).to(device)
    # per-step discounts (1+rΔt)^{-n} at grid index n = 1..N
    disc = ((1.0 + rate * dt) ** (-(np.arange(N) + 1.0))).astype(np.float32)
    ex_date = (np.arange(1, N + 1) % k_ex) == 0
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def one_batch():
        X = x0.expand(batch, D)
        alive = torch.ones((batch,), dtype=dtype, device=device)
        pv = torch.zeros((batch,), dtype=dtype, device=device)
        early = torch.zeros((), dtype=dtype, device=device)
        for n in range(N):
            dw = sqrt_dt * _normals(gen, batch, Dw, dtype)
            if chol_T is not None:
                dw = dw @ chol_T
            X1, _ = euler_step(problem, n, X, dw, dt)
            t1 = torch.full((batch, 1), (n + 1) * dt, dtype=dtype, device=device)
            g1 = problem.g(X1)[:, 0]
            # maturity pays regardless of the net; earlier dates exercise where
            # the payoff beats the learned continuation
            if n + 1 == N:
                stop = torch.ones_like(alive)
            elif ex_date[n]:
                u1 = problem.transform_u(t1, X1, net(torch.cat([t1, X1], dim=-1)))[:, 0]
                stop = ((g1 > 0.0) & (g1 > u1)).to(dtype)
            else:
                stop = torch.zeros_like(alive)
            exf = alive * stop
            pv = pv + exf * float(disc[n]) * g1
            alive = alive - exf
            if n + 1 < N:
                early = early + exf.sum()
            X = X1
        # centred per-batch moments: f32-safe pooling on the host
        m = pv.mean()
        return m, torch.mean(torch.square(pv - m)), early

    means, varis, early = [], [], 0.0
    with torch.no_grad():
        for _ in range(n_batches):
            bm, bv, be = (float(v) for v in one_batch())
            means.append(bm)
            varis.append(bv)
            early += be
    n = n_batches * batch
    mean = float(np.mean(means))
    # pooled variance: within-batch + between-batch spread of batch means
    var = float(np.mean(varis) + np.var(means))
    se = float(np.sqrt(var / n))
    g0 = float(problem.g(x0.cpu()[None, :])[0, 0])
    immediate = g0 > mean
    return PolicyValue(
        value=float(max(g0, mean)), standard_error=se, n_paths=n, N=N,
        rate=rate, exercise_fraction=float(early / n), immediate=immediate,
    )


def policy_value_from_trainer(
    trainer, N: Optional[int] = None, use_ema: bool = True, **kwargs
) -> PolicyValue:
    """Run a trained ``Trainer``'s stopping rule: its own time grid N and,
    by default, the EMA shadow (the serving read). Extra kwargs pass through
    to :func:`policy_value`."""
    net = trainer.ema_params if use_ema else trainer.params
    return policy_value(trainer.problem, net, trainer.N if N is None else N, **kwargs)
