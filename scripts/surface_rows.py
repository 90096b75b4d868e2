#!/usr/bin/env python3
"""The JAX package's Heston surface study at its full budget, on the PyTorch
port and one NVIDIA GPU:

    python3 scripts/surface_rows.py [SEED ...] [--out DIR]

Each seed (default 0) runs ``HestonSurfaceExecutor`` on the unmodified
``SurfaceConfig()`` recipe (M = 1024, N = 50, FC-Sine [3, 512 x 4, 1], local
objective, "bs" head, lognormal X0 at scale 0.3, EMA 0.999; budget 20000,
which the reference's split trains as 10000 at 1e-3, 5000 at 1e-4 and
10000 at 1e-5, 25000 iterations) with what the JAX study
(``scripts/studies_r4.py::surface_executor``) adds: the smile graded at
t = 0, 0.25, 0.5, and the t = 0 smile also against the discrete-N BSDE
oracle with 4,194,304 paths per strike.

Prints one JSON line per seed (every CSV row, the training wall time and
iterations/s, the mean |IV error| against its bound of 0.5 volpts, and the
JAX study's rows beside, from TPU runs), then the card's name and power
limit. The CSVs and plots go to ``DIR/seed<k>`` (default
``build/surface_rows``). ``row(seed, **overrides)`` takes
``SurfaceConfig`` overrides, for a short rehearsal from Python with
``DEVICE = "cpu"``.
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

DISCRETE_PATHS = 4_194_304
SMILE_T_EVALS = (0.0, 0.25, 0.5)
BOUND_VOLPTS = 0.5  # max(1 %, 3 x the JAX study's worst seed, 0.165 volpts)
DEVICE = None  # the card; a rehearsal on the CPU sets "cpu"
# results_r4/surface_executor.log (TPU runs, seeds 0, 1, 2): accuracy only
JAX_ROWS = {
    0: {"mean_abs_iv_err_volpts": 0.164526, "price_rel_l2": 0.00175, "delta_rel_l2": 0.004085,
        "gamma_rel_l2": 0.034751, "price2d_rel_l2": 0.004058, "vega_rel_l2": 0.084939},
    1: {"mean_abs_iv_err_volpts": 0.094684, "price_rel_l2": 0.001109, "delta_rel_l2": 0.001908,
        "gamma_rel_l2": 0.019079, "price2d_rel_l2": 0.004131, "vega_rel_l2": 0.132203},
    2: {"mean_abs_iv_err_volpts": 0.063179, "price_rel_l2": 0.000982, "delta_rel_l2": 0.001396,
        "gamma_rel_l2": 0.011805, "price2d_rel_l2": 0.004849, "vega_rel_l2": 0.117826},
}


def iterations(budget: int) -> int:
    """The iterations the executor trains for ``budget`` (its three-phase
    split: budget // 2, budget // 4, budget - 2 * (budget // 4))."""
    return budget // 2 + budget // 4 + budget - 2 * (budget // 4)


def row(seed: int = 0, out: str = "build/surface_rows", **overrides) -> dict:
    from dnnpde_tpu_torch.experiments import HestonSurfaceExecutor, SurfaceConfig

    kw = {"seed": seed, "discrete_oracle_paths": DISCRETE_PATHS,
          "smile_t_evals": SMILE_T_EVALS, **overrides}
    cfg = SurfaceConfig(**kw)
    t0 = time.perf_counter()
    rep = HestonSurfaceExecutor(cfg, f"{out}/seed{seed}", device=DEVICE).execute()
    wall = time.perf_counter() - t0
    smile = rep.rows[0]
    n_iter = iterations(cfg.budget)
    return {"seed": seed, "config": {k: v for k, v in kw.items() if k != "seed"},
            "iterations": n_iter, "train_wall_s": smile["run_time"],
            "it_per_s": n_iter / smile["run_time"], "wall_s": wall,
            "mean_abs_iv_err_volpts": smile["mean_abs_iv_err_volpts"], "bound": BOUND_VOLPTS,
            "within_bound": bool(smile["mean_abs_iv_err_volpts"] <= BOUND_VOLPTS),
            "rows": rep.rows, "jax_tpu_rows": JAX_ROWS.get(seed)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seeds", nargs="*", type=int, help="default: 0")
    ap.add_argument("--out", default="build/surface_rows")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("surface_rows: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds or [0]:
        print(json.dumps(row(seed, args.out)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
