"""Time-step Richardson extrapolation of the deep-BSDE value, the counterpart
of ``dnnpde_tpu/train/extrapolation.py``.

Train at resolutions N and 2N and combine

    Y0* = 2·Y0(2N) − Y0(N)

which cancels the O(dt) term of the Euler BSDE recursion's weak bias. The
training runs through the port's :class:`~dnnpde_tpu_torch.train.Trainer`;
pass trainers to reuse their captured chunks across seeds (``reset(seed)``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dnnpde_tpu_torch.solver.bsde import make_net_u
from dnnpde_tpu_torch.train.trainer import Trainer


def train_y0(
    problem,
    M: int,
    N: int,
    phases: Sequence[tuple[int, float]],
    seed: int = 0,
    warmup: int = 250,
    optimizer: str = "Adam",
    tail: int = 5,
    trainer: Optional[Trainer] = None,
    use_ema: bool = False,
    **trainer_kwargs,
) -> float:
    """Train and return the mean of the last ``tail`` logged Y0s (the repo's
    standard read), or with ``use_ema`` the EMA net's u at (0, x0).

    A ``warmup`` of that many iterations at the first phase's rate precedes
    the phases. Pass ``trainer`` to reuse its captured chunks across seeds
    (``trainer.reset(seed)`` is applied); otherwise one is built from
    ``trainer_kwargs`` (``device`` among them)."""
    if trainer is None:
        trainer = Trainer(problem, M=M, N=N, **trainer_kwargs)
    trainer.reset(seed)
    if warmup:
        trainer.train(warmup, phases[0][1], optimizer, log_every=warmup, verbose=False)
    for n_it, lr in phases:
        trainer.train(n_it, lr, optimizer, log_every=500, verbose=False)
    if use_ema:
        dev = trainer.device
        net_u = make_net_u(trainer.ema_params, transform=problem.transform_u)
        with torch.no_grad():
            u, _ = net_u(torch.zeros((1, 1), device=dev), problem.x0.to(dev)[None, :])
        return float(u[0, 0])
    return float(np.mean(trainer.y0_log[-tail:]))


def richardson_y0(
    problem,
    M: int = 128,
    N: int = 50,
    phases: Sequence[tuple[int, float]] = ((10000, 1e-3), (5000, 1e-4), (5000, 1e-5)),
    seed: int = 0,
    trainers: Optional[tuple[Trainer, Trainer]] = None,
    **trainer_kwargs,
) -> dict[str, float]:
    """Two-resolution training and the first-order Richardson combination:
    ``{"y0_N": ..., "y0_2N": ..., "y0_richardson": 2·y0_2N − y0_N}``.
    ``trainers`` (one at N, one at 2N) reuse their captured chunks across
    seeds."""
    tr_n = trainers[0] if trainers else None
    tr_2n = trainers[1] if trainers else None
    y_n = train_y0(problem, M, N, phases, seed, trainer=tr_n, **trainer_kwargs)
    y_2n = train_y0(problem, M, 2 * N, phases, seed, trainer=tr_2n, **trainer_kwargs)
    return {"y0_N": y_n, "y0_2N": y_2n, "y0_richardson": 2.0 * y_2n - y_n}
