#!/usr/bin/env python3
"""The JAX package's replica studies at their full budget, on the PyTorch
port and one NVIDIA GPU:

    python3 scripts/replica_rows.py [M ...]

Each M (default 128 256 512) trains the r4 replica matrix
(``scripts/studies_r4.py::replica_matrix``): ``train_replicas`` on
``HestonPDE(clamp_output=True, clamp_smoothing="bs")``, FC-Sine
[3, 256 x 4, 1], K = 3 seeds (0, 1, 2), N = 50, the 20k anneal (10000 at
1e-3, 5000 at 1e-4, 5000 at 1e-5), EMA 0.999, logs every 2000, nothing cut;
each replica's EMA read at x0 (``replica_values_at``) is graded against the
Heston closed form within max(1 %, 3 x the JAX study's worst 0.368 %) =
1.1 %. Beside it: the program's wall and warm-up/capture seconds, its
replica-iterations/s, and one solo ``Trainer``'s captured it/s on the same
configuration over ``SOLO_ITERS`` iterations after a warm-up window, with
the serial wall that rate implies for the K runs.

Prints one JSON line per row, with the JAX study's rows
(``BENCH_REPORT_r4.jsonl``, TPU runs) beside for accuracy only, then the
card's name and power limit. For a short rehearsal from Python, set
``DEVICE = "cpu"`` and pass ``phases``, ``layers`` and ``solo_iters`` to
``heston_row``.
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

PHASES = ((10000, 1e-3), (5000, 1e-4), (5000, 1e-5))
SEEDS = (0, 1, 2)
LAYERS = [3, 256, 256, 256, 256, 1]
EMA = 0.999
LOG_EVERY = 2000
BOUND = 0.011  # max(1 %, 3 x the JAX study's worst seed, 0.368 %)
SOLO_ITERS = 200  # the solo Trainer's timed window
DEVICE = None  # the card; a rehearsal on the CPU sets "cpu"
# BENCH_REPORT_r4.jsonl:47-59 (TPU runs): accuracy only
JAX_ROWS = {
    128: {"ema_y0": [0.198945, 0.19884, 0.19908], "signed_rel": [0.00264, 0.00211, 0.00332]},
    256: {"ema_y0": [0.198946, 0.198924, 0.198807], "signed_rel": [0.00265, 0.00254, 0.00195]},
    512: {"ema_y0": [0.198991, 0.198942, 0.199151], "signed_rel": [0.00287, 0.00263, 0.00368]},
}


def _sync() -> None:
    if torch.cuda.is_available() and DEVICE != "cpu":
        torch.cuda.synchronize()


def solo_rate(problem, M: int, N: int, layers, iters: int, **kw) -> float:
    """One solo ``Trainer``'s it/s on captured chunks of ``iters``, after a
    warm-up window of the same length."""
    from dnnpde_tpu_torch.train import Trainer

    tr = Trainer(problem, M=M, N=N, layers=layers, seed=0, ema_decay=EMA, device=DEVICE, **kw)
    tr.train(iters, 1e-3, log_every=iters, verbose=False)
    _sync()
    t0 = time.perf_counter()
    tr.train(iters, 1e-3, log_every=iters, verbose=False)
    _sync()
    return iters / (time.perf_counter() - t0)


def heston_row(M: int, phases=PHASES, layers=LAYERS, solo_iters: int = SOLO_ITERS) -> dict:
    from dnnpde_tpu_torch.numerics import HestonParams, heston_call_price
    from dnnpde_tpu_torch.pde import HestonPDE
    from dnnpde_tpu_torch.train import replica_values_at, train_replicas

    p = HestonPDE(clamp_output=True, clamp_smoothing="bs")
    cf = float(heston_call_price(p.S0, p.v0, HestonParams(
        K=p.strike, r=p.r, T=p.T, kappa=p.kappa, theta=p.theta, sigma=p.sigma_v, rho=p.rho,
        v0=p.v0), device=DEVICE))
    res = train_replicas(p, SEEDS, phases, M=M, N=50, layers=layers, ema_decay=EMA,
                         log_every=LOG_EVERY, device=DEVICE)
    u = replica_values_at(p, res, layers=layers)[:, 0]
    rel = (u - cf) / cf
    iters = sum(n for n, _ in phases)
    solo = solo_rate(p, M, 50, layers, solo_iters)
    return {"study": "replica_matrix", "M": M, "N": 50, "seeds": list(res.seeds),
            "iterations": iters, "ema_y0": u.tolist(), "oracle_cf": cf,
            "signed_rel": rel.tolist(), "bound": BOUND,
            "within_bound": bool(np.all(np.abs(rel) <= BOUND)),
            "wall_time_s": res.wall_time, "compile_time_s": res.compile_time,
            "replica_it_per_s": len(SEEDS) * iters / res.wall_time,
            "solo_it_per_s": solo, "serial_wall_s_at_solo_rate": len(SEEDS) * iters / solo,
            "last_logged_loss": res.losses[:, -1].tolist(), "jax_tpu_rows": JAX_ROWS.get(M)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("Ms", nargs="*", type=int, help="default: 128 256 512")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("replica_rows: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for M in args.Ms or [128, 256, 512]:
        print(json.dumps(heston_row(M)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
