#!/usr/bin/env python3
"""The spread over seeds of the two CLI runs whose accuracy ``chip_smoke.py``
grades at the CLI's default seed (42), on one NVIDIA GPU:

    python3 scripts/cli_seeds.py

- ``chip_smoke.CLI_BARRIER``: the barrier call at N = 10, M = 4096, 2000
  iterations at 1e-3 then 1000 at 1e-4 (the objective resolved to local),
  graded by its ``learned_y0`` (and, beside it, its ``ema_y0``) against
  the discrete oracle;
- ``chip_smoke.CLI_CALL1D``: the 1-D call on [2, 32 x 4, 1], M = 256,
  N = 10, 800 + 200 iterations, then a 400-step LBFGS polish on 8192 frozen
  paths, exported; graded by its ``learned_y0`` and by the Y0 that the
  export serves, against Black-Scholes.

Each run goes through ``python3 -m dnnpde_tpu_torch`` in a child process
(``chip_smoke.run_cli``), at the seeds ``BARRIER_SEEDS`` and
``CALL1D_SEEDS``. Prints one JSON line per run (the summary, the graded
value's relative error, the polish's first and last loss, wall seconds),
then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

BARRIER_SEEDS = (0, 1, 2, 3)
CALL1D_SEEDS = (0, 1, 2)


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        for seed in BARRIER_SEEDS:
            r = chip_smoke.run_cli(chip_smoke.CLI_BARRIER + ["--seed", str(seed)],
                                   f"{tmp}/barrier_{seed}")
            s = r["summary"]
            print(json.dumps({"run": "barrier_call", "seed": seed, "seconds": r["seconds"], **s,
                              "ema_rel_error": abs(s["ema_y0"] - s["oracle_y0"])
                              / s["oracle_y0"]}), flush=True)
        for seed in CALL1D_SEEDS:
            art = f"{tmp}/call1d_{seed}.pt"
            r = chip_smoke.run_cli(chip_smoke.CLI_CALL1D + ["--seed", str(seed), "--export", art],
                                   f"{tmp}/call1d_{seed}")
            s = r["summary"]
            served = chip_smoke.served_y0(art, np.ones(1), None)
            print(json.dumps({"run": "call1d_polish", "seed": seed, "seconds": r["seconds"], **s,
                              "served_y0": served,
                              "served_rel_error": abs(served - s["oracle_y0"]) / s["oracle_y0"],
                              "polish_loss_first_last": chip_smoke._polish_losses(r["stdout"])}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
