#!/usr/bin/env python3
"""The JAX package's three optimal-stopping studies at their full budgets,
on the PyTorch port and one NVIDIA GPU:

    python3 scripts/stopping_rows.py [american_put heston_american max_call]

Each row trains FC-Sine [D+1, 256 x 4, 1] with the reflected local
objective, M = 1024, seed 0, ``ema_decay`` 0.999, through ``Trainer.train``
in captured chunks of 2000 iterations: 10000 iterations at 1e-3, then 5000
at 1e-4 and 5000 at 1e-5 (20000 in all), the protocol of
``scripts/studies_r4.py`` and ``scripts/studies_r5.py``:

- ``american_put`` (``studies_r4.american_put_head``, the local arm):
  ``AmericanPutOption()`` with its European-put head, N = 50; the learned
  value is the last logged Y0, graded against the Bermudan-50 CRR tree
  (4000 steps, exercise every 80);
- ``heston_american`` (``studies_r4.heston_american``, the bs arm):
  ``HestonAmericanPut()``, N = 50; the learned value is ``value_u`` of the
  EMA net at x0, graded against the port's ``lsmc_value`` (262,144
  regression and 1,048,576 pricing paths, seed 99);
- ``max_call`` (``studies_r5.max_call`` at d = 2, one ``Trainer`` in place
  of the JAX package's replicas): ``BermudanMaxCall(D=2)``, N = 45; graded
  by the EMA net's ``policy_value`` (1,048,576 paths, seed 777) against the
  published 13.902 and the port's sorted-basis ``lsmc_value`` (131,072 and
  524,288 paths, seed 0).

Prints one JSON line per row (the learned value, its oracle, the relative
error, iterations/s and wall time, the row's acceptance bound, and the
logged Y0 at each log point), then
the card's name and power limit. ``--scale S`` multiplies the budget and
the oracles' path counts (0.25 and 0.5 gave PERF.md's short-budget put).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import PUBLISHED_MAX_CALL_D2, value_at_x0  # noqa: E402

BUDGET = 20000
PHASES = ((0.5, 1e-3), (0.25, 1e-4), (0.25, 1e-5))  # share of the budget, learning rate
LOG_EVERY = 2000
M_PATHS, WIDTH, EMA_DECAY, SEED = 1024, 256, 0.999, 0
DEVICE = None  # the card; a rehearsal on the CPU sets "cpu" and shrinks the above
# the JAX package's recorded LSMC values (results_r4/heston_american.log,
# results_r5/max_call.log), value and standard error
JAX_LSMC = {"heston_american": (0.1552541, 0.00015), "max_call": (13.8602, 0.0209)}
# acceptance: within the larger of 1 % and 3x the JAX package's error
BOUND = {"american_put": 0.0105, "heston_american": 0.01, "max_call": 0.01}


def _paths(n: int, scale: float) -> int:
    return max(1024, int(n * scale))


def _train(trainer, budget: int) -> tuple[float, list]:
    """The three phases; returns the training wall time and the mean logged
    loss at each log point."""
    log_every = min(LOG_EVERY, max(1, int(budget * PHASES[-1][0])))
    t0 = time.perf_counter()
    for share, lr in PHASES:
        trainer.train(max(1, int(budget * share)), lr, log_every=log_every, verbose=False)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    return time.perf_counter() - t0, list(trainer.training_loss)


def _trainer(prob, N: int):
    from dnnpde_tpu_torch.train import Trainer

    return Trainer(prob, M=M_PATHS, N=N, layers=[prob.dim + 1] + [WIDTH] * 4 + [1], seed=SEED,
                   ema_decay=EMA_DECAY, objective="local", device=DEVICE)


def _row(name: str, trainer, seconds: float, budget: int, losses, **out) -> dict:
    rel = out["rel_err"]
    return {"row": name, "M": trainer.M, "N": trainer.N, "budget": budget, "seed": SEED,
            **out, "bound": BOUND[name], "within_bound": bool(rel <= BOUND[name]),
            "it_per_s": budget / seconds, "train_wall_s": seconds,
            "mean_loss_first_last": [losses[0], losses[-1]],
            "log_iterations": list(trainer.iteration), "y0_logs": list(trainer.y0_log)}


def american_put(scale: float = 1.0) -> dict:
    from dnnpde_tpu_torch.numerics import crr_binomial
    from dnnpde_tpu_torch.pde import AmericanPutOption

    t0 = time.perf_counter()
    N, prob = 50, AmericanPutOption()
    n_tree = 80 * N
    kw = dict(S0=1.0, K=prob.K, T=prob.T, r=prob.r, sigma=prob.sigma_bar, n_steps=n_tree,
              payoff="put")
    berm = crr_binomial(american=True, exercise_every=n_tree // N, **kw)
    euro = crr_binomial(american=False, **kw)
    tr = _trainer(prob, N)
    budget = max(4, int(BUDGET * scale))
    seconds, losses = _train(tr, budget)
    y0 = float(tr.y0_log[-1])
    return _row("american_put", tr, seconds, budget, losses, learned_y0=y0,
                oracle_bermudan_n=berm, oracle_european=euro,
                rel_err=abs(y0 - berm) / berm, premium_captured=(y0 - euro) / (berm - euro),
                wall_s=time.perf_counter() - t0)


def heston_american(scale: float = 1.0) -> dict:
    from dnnpde_tpu_torch.numerics import lsmc_value
    from dnnpde_tpu_torch.pde import HestonAmericanPut

    t0 = time.perf_counter()
    N, prob = 50, HestonAmericanPut()
    ls = lsmc_value(prob, N=N, n_regression=_paths(262_144, scale),
                    n_pricing=_paths(1_048_576, scale), seed=99, device=DEVICE)
    ls_seconds = time.perf_counter() - t0
    tr = _trainer(prob, N)
    budget = max(4, int(BUDGET * scale))
    seconds, losses = _train(tr, budget)
    y0 = value_at_x0(tr, use_ema=True)
    jv, jse = JAX_LSMC["heston_american"]
    return _row("heston_american", tr, seconds, budget, losses, learned_y0=y0,
                oracle_lsmc=ls.value, lsmc_se=ls.standard_error,
                lsmc_in_sample=ls.in_sample_value, lsmc_seconds=ls_seconds,
                lsmc_z_vs_jax=(ls.value - jv) / float(np.hypot(ls.standard_error, jse)),
                rel_err=abs(y0 - ls.value) / ls.value, wall_s=time.perf_counter() - t0)


def max_call(scale: float = 1.0) -> dict:
    from dnnpde_tpu_torch.evals import policy_value
    from dnnpde_tpu_torch.numerics import lsmc_value
    from dnnpde_tpu_torch.pde import BermudanMaxCall

    t0 = time.perf_counter()
    N, prob = 45, BermudanMaxCall(D=2, N_steps=45)
    ls = lsmc_value(prob, N=N, n_regression=_paths(131_072, scale),
                    n_pricing=_paths(524_288, scale), seed=0, basis="sorted", device=DEVICE)
    ls_seconds = time.perf_counter() - t0
    tr = _trainer(prob, N)
    budget = max(4, int(BUDGET * scale))
    seconds, losses = _train(tr, budget)
    direct = value_at_x0(tr, use_ema=True)
    t1 = time.perf_counter()
    pv = policy_value(prob, tr.ema_params, N=N, n_paths=_paths(1_048_576, scale), seed=777)
    pv_seconds = time.perf_counter() - t1
    pub = PUBLISHED_MAX_CALL_D2
    jv, jse = JAX_LSMC["max_call"]
    return _row("max_call", tr, seconds, budget, losses, policy_value=pv.value,
                policy_se=pv.standard_error, policy_seconds=pv_seconds,
                exercise_fraction=pv.exercise_fraction, direct_y0=direct, published=pub,
                lsmc=ls.value, lsmc_se=ls.standard_error, lsmc_seconds=ls_seconds,
                lsmc_z_vs_jax=(ls.value - jv) / float(np.hypot(ls.standard_error, jse)),
                z_policy_vs_lsmc=(pv.value - ls.value) / ls.standard_error,
                rel_err=abs(pv.value - pub) / pub, rel_err_direct=abs(direct - pub) / pub,
                wall_s=time.perf_counter() - t0)


ROWS = {"american_put": american_put, "heston_american": heston_american,
        "max_call": max_call}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*", choices=[*ROWS, []], help="default: all three")
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stopping_rows: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in args.rows or list(ROWS):
        row = ROWS[name](args.scale)
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
