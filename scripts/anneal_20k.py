#!/usr/bin/env python3
"""The reference's 20k-iteration four-phase anneal on the port's flagship, on
one NVIDIA GPU:

    python3 scripts/anneal_20k.py

BSB-100, FC-Sine [101, 256 x 4, 1], M = 100, N = 50, Adam through
``Trainer.train`` on the kernel pair K1 + K2 (captured chunks of 100
iterations), phases of 5000 iterations at 1e-3, 1e-4, 1e-5 and 1e-6: the
protocol of the JAX package's ``bench/harness.py`` (``_run`` with
``bench_call_1d``'s phases). As there, 100 iterations at the first phase's
rate run first, outside the timed region, and the learned Y0 is the mean of
the last three logged Y0s of the final phase, against the closed form
u(0, x0) = 77.1049. Prints the card's name and power limit, then one JSON
line: wall time, iterations/s, the learned Y0 and its relative error, and Y0
at the end of each phase.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PHASES = ((5000, 1e-3), (5000, 1e-4), (5000, 1e-5), (5000, 1e-6))
LOG_EVERY = 100


def anneal(dim: int = 100, width: int = 256, M: int = 100, N: int = 50, scale: float = 1.0,
           seed: int = 0, device=None) -> dict:
    """The anneal at these sizes (``scale`` multiplies the phases'
    iteration counts, each at least one chunk); on CPU tensors the kernels
    take their plain versions."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    prob = BlackScholesBarenblatt(D=dim)
    exact = float(prob.exact_solution(torch.zeros(1, 1), prob.x0[None])[0, 0])
    trainer = Trainer(prob, M=M, N=N, layers=[dim + 1] + [width] * 4 + [1], seed=seed,
                      solver_config=SolverConfig(fused_net_u="cuda", remat=False), device=device)
    phases = [(max(LOG_EVERY, int(n * scale)), lr) for n, lr in PHASES]
    trainer.train(LOG_EVERY, phases[0][1], log_every=LOG_EVERY, verbose=False)  # capture
    t0 = time.perf_counter()
    ends = []
    for n, lr in phases:
        trainer.train(n, lr, log_every=LOG_EVERY, verbose=False)
        ends.append(trainer.y0_log[-1])
    wall = time.perf_counter() - t0
    iters = sum(n for n, _ in phases)
    fine_logs = max(1, phases[-1][0] // LOG_EVERY)
    learned = float(np.mean(trainer.y0_log[-min(3, fine_logs):]))
    return {"path": "kernels K1+K2", "M": M, "N": N, "D": dim,
            "phases": phases, "iterations": iters, "wall_s": wall, "it_per_s": iters / wall,
            "learned_y0": learned, "exact_y0": exact,
            "rel_error": abs(learned - exact) / abs(exact), "y0_at_phase_ends": ends,
            "final_mean_loss": trainer.training_loss[-1]}


def main() -> int:
    if not torch.cuda.is_available():
        print("anneal_20k: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps(anneal()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
