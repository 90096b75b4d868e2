#!/usr/bin/env python3
"""Training rates, K1's, K2's and K4's times and one traced training
iteration of one checkout of this repo, on one NVIDIA GPU, for comparing two
commits within one call:

    python3 scripts/time_tree.py TREE
    python3 scripts/time_tree.py TREE --basket-seeds 1-8

TREE is the root of a checkout (for example a ``git archive`` of the parent
commit unpacked under ``build/``). The script imports that tree's
``chip_smoke.py`` and ``dnnpde_tpu_torch``, builds the tree's kernels into
the tree's own ``build/``, and runs its ``time_k1`` (K1 at B = 4096 and 100,
and by batch), its ``time_k2`` (K2, its plain version and its library
yardstick at B = 100 and 2048) and its ``time_training`` (iterations/s at
M = 100, 512, 2048 on the kernel path and on the f32 autograd path) at full
width, FC-Sine [101, 256 x 4, 1] with weights from seed 0, then this
checkout's ``chip_smoke.time_k4`` and ``chip_smoke.trace_iteration`` on the
tree's package: K4 (``gbm_terminal``), its plain version and its bound at
M = 131072, D = 100, N = 50 uncorrelated and correlated and the basket
path's N = 1, and a BSB-100 kernel-path iteration at M = 100 under
``torch.profiler`` (wall ms, device-busy ms, K1's and K2's share). It
prints the card's name and power limit and, last, one JSON line with the
numbers. Host-clock rates move
between calls, so compare trees within one call, in the order parent,
change, change, parent, one process per tree.

With ``--basket-seeds A-B`` it instead trains the basket call as
``chip_smoke.py``'s basket path does (BasketCallOption(D=100) on K1 + K2,
the tree's own layers, batch, steps, iterations and logging) once for each
seed A..B, and prints each run's mean logged losses, loss fall and last Y0:
the spread of the 400-iteration loss fall over seeds, for one tree's kernels.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def basket_falls(chip_smoke, device, seeds) -> dict:
    from dnnpde_tpu_torch.pde import BasketCallOption
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    prob = BasketCallOption(D=chip_smoke.D)
    runs = {}
    for seed in seeds:
        trainer = Trainer(prob, M=chip_smoke.TRAIN_M, N=chip_smoke.N_STEPS,
                          layers=chip_smoke.LAYERS,
                          solver_config=SolverConfig(fused_net_u="cuda", remat=False),
                          seed=seed, device=device)
        res = trainer.train(chip_smoke.TRAIN_ITERS, 1e-3, "Adam",
                            log_every=chip_smoke.TRAIN_LOG_EVERY, verbose=False)
        losses = res.graph[1]
        runs[seed] = {"losses": losses.tolist(), "fall": float(losses[0] / losses[-1]),
                      "y0": float(res.y0_history[-1])}
        print(f"seed {seed}: {json.dumps(runs[seed])}", flush=True)
    return runs


def this_chip_smoke():
    """This checkout's ``chip_smoke``, whose functions then run on whatever
    ``dnnpde_tpu_torch`` is imported (the tree's, whose own chip_smoke.py
    may predate them)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    args = sys.argv[1:]
    seeds = None
    if len(args) == 3 and args[1] == "--basket-seeds":
        first, last = (int(s) for s in args[2].split("-"))
        seeds = range(first, last + 1)
        args = args[:1]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(args[0]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("time_tree: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import chip_smoke
    from dnnpde_tpu_torch.ops import _build

    if not Path(chip_smoke.__file__).resolve().is_relative_to(tree):
        print(f"time_tree: imported {chip_smoke.__file__}, not {tree}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    if seeds is not None:
        runs = basket_falls(chip_smoke, device, seeds)
        print(json.dumps({"tree": str(tree), "basket": runs}))
        return 0
    Ws, bs = chip_smoke.weights(chip_smoke.make_net(device))
    k1 = chip_smoke.time_k1(Ws, bs, device)
    k2 = chip_smoke.time_k2(Ws, bs, device)
    here = this_chip_smoke()
    k4 = here.time_k4(device)
    rates = chip_smoke.time_training(device)
    iteration = here.trace_iteration(device)
    print(json.dumps({"tree": str(tree), "training": rates, "k1_B4096_ms": k1["ms"],
                      "k2_B100": k2, "k4": k4, "iteration": iteration}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
