#!/usr/bin/env python3
"""The JAX package's path-dependent studies at their full budgets, on the
PyTorch port and one NVIDIA GPU:

    python3 scripts/path_rows.py [barrier asian lookback]

Each row trains FC-Sine [3, 256 x 4, 1] with the local objective (the
CLI's resolution for ``post_step`` problems), M = 1024, N = 50, seed 0,
``ema_decay`` 0.999, through ``Trainer.train`` in captured chunks of 2000
iterations: 10000 iterations at 1e-3, then 5000 at 1e-4 and 5000 at 1e-5
(20000 in all), the protocol of ``scripts/studies_r4.py``'s
``barrier_call`` (smooth monitor, local arm) and ``asian_lookback`` (local
arms). The learned value is the last logged Y0, graded against the exact
discrete oracle ``discrete_bsde_value`` on the same Euler + post_step chain
(4,194,304 antithetic paths, seed 99); the Asian row is also bracketed
below by the geometric-average closed form and the lookback row above by
the continuously monitored closed form.

Prints one JSON line per row (learned value, oracle and its SE, relative
error, its bound, iterations/s and wall times, the logged Y0 and mean loss
at each log point), then the card's name and power limit. ``row(name,
scale)`` multiplies the budget and the oracle's path count by ``scale``,
for a short rehearsal from Python.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BUDGET = 20000
PHASES = ((0.5, 1e-3), (0.25, 1e-4), (0.25, 1e-5))  # share of the budget, learning rate
LOG_EVERY = 2000
N_STEPS, M_PATHS, WIDTH, EMA_DECAY, SEED = 50, 1024, 256, 0.999, 0
ORACLE_PATHS, ORACLE_SEED = 4_194_304, 99
DEVICE = None  # the card; a rehearsal on the CPU sets "cpu" and shrinks the above
# acceptance: within the larger of 1 % and 3x the JAX package's README error
BOUND = {"barrier": 0.0267, "asian": 0.027, "lookback": 0.0306}


def _problem(name: str):
    from dnnpde_tpu_torch.pde import AsianCallOption, LookbackCallOption, UpAndOutCall

    return {"barrier": UpAndOutCall, "asian": lambda: AsianCallOption(N_samples=N_STEPS),
            "lookback": LookbackCallOption}[name]()


def _bracket(name: str, prob):
    """The closed-form bracket of the JAX study: (its name, its value)."""
    from dnnpde_tpu_torch.numerics import geometric_asian_call, lookback_call_floating

    dev = "cpu" if DEVICE == "cpu" else None
    if name == "asian":
        return "geometric_lower", geometric_asian_call(1.0, prob.strike, prob.T, prob.r,
                                                       prob.sigma_bar, N_STEPS, device=dev)
    if name == "lookback":
        return "continuous_upper", lookback_call_floating(1.0, prob.T, prob.r, prob.sigma_bar,
                                                          device=dev)
    return None, None


def row(name: str, scale: float = 1.0) -> dict:
    from dnnpde_tpu_torch.numerics import discrete_bsde_value
    from dnnpde_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    prob = _problem(name)
    oracle = discrete_bsde_value(prob, N=N_STEPS, n_paths=max(1024, int(ORACLE_PATHS * scale)),
                                 seed=ORACLE_SEED, device=DEVICE)
    oracle_s = time.perf_counter() - t0
    tr = Trainer(prob, M=M_PATHS, N=N_STEPS, layers=[prob.dim + 1] + [WIDTH] * 4 + [1],
                 seed=SEED, ema_decay=EMA_DECAY, objective="local", device=DEVICE)
    budget = max(4, int(BUDGET * scale))
    log_every = min(LOG_EVERY, max(1, int(budget * PHASES[-1][0])))
    t1 = time.perf_counter()
    for share, lr in PHASES:
        tr.train(max(1, int(budget * share)), lr, log_every=log_every, verbose=False)
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    seconds = time.perf_counter() - t1
    y0 = float(tr.y0_log[-1])
    rel = abs(y0 - oracle.value) / oracle.value
    bname, bval = _bracket(name, prob)
    return {"row": name, "M": tr.M, "N": tr.N, "budget": budget, "seed": SEED,
            "learned_y0": y0, "oracle_discrete": oracle.value,
            "oracle_se": oracle.standard_error, "oracle_paths": oracle.n_paths,
            "oracle_seconds": oracle_s, "rel_err": rel, "bound": BOUND[name],
            "within_bound": bool(rel <= BOUND[name]),
            **({"bracket": bname, "bracket_value": bval} if bname else {}),
            "it_per_s": budget / seconds, "train_wall_s": seconds,
            "wall_s": time.perf_counter() - t0, "log_iterations": list(tr.iteration),
            "y0_logs": list(tr.y0_log), "mean_loss_logs": list(tr.training_loss)}


ROWS = ("barrier", "asian", "lookback")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*", choices=[*ROWS, []], help="default: all three")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("path_rows: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in args.rows or ROWS:
        print(json.dumps(row(name)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
