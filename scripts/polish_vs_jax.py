#!/usr/bin/env python3
"""The 400-step LBFGS polish of the 1-D call in the JAX package and in the
PyTorch port, from one warm start and one frozen batch, on the CPU:

    python3 scripts/polish_vs_jax.py SEED [SEED ...]

For each seed, the JAX ``Trainer`` runs the protocol of
``tests/test_convergence.py::test_lbfgs_polish_phase_reaches_tight_gate``
(``CallOption1D(D=1)``, M = 256, N = 10, FC-Sine [2, 32 x 4, 1], 800 Adam
iterations at 1e-3 and 200 at 1e-4); the port's ``Trainer`` takes those
weights, and both polish 400 steps on the frozen antithetic batch that JAX
draws for ``polish(M=8192, seed=123)``. Prints one JSON line per seed: the
warm, JAX-polished and port-polished Y0 and their errors against
Black-Scholes, and each polish's first and last loss. It shows how far the
polished Y0 lands from Black-Scholes in the reference itself at this budget.
Imports both packages, as the port's parity tests do; ~10 minutes a seed.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dnnpde_tpu.numerics import black_scholes_call  # noqa: E402
from dnnpde_tpu.pde import CallOption1D as JaxCall  # noqa: E402
from dnnpde_tpu.sim.brownian import brownian_increments  # noqa: E402
from dnnpde_tpu.train import Trainer as JaxTrainer  # noqa: E402
from dnnpde_tpu_torch.params import from_flax_params  # noqa: E402
from dnnpde_tpu_torch.pde import CallOption1D  # noqa: E402
from dnnpde_tpu_torch.sim import time_grid  # noqa: E402
from dnnpde_tpu_torch.train import Trainer  # noqa: E402

POLISH_STEPS, POLISH_M, POLISH_SEED = 400, 8192, 123


def _jax_polish_batch(jtr):
    """The frozen antithetic batch ``jtr.polish(M=POLISH_M, seed=POLISH_SEED)`` draws."""
    p = jtr.problem
    kw, _, _ = jax.random.split(jax.random.PRNGKey(POLISH_SEED), 3)
    dW = brownian_increments(kw, POLISH_M, jtr.N, p.noise_dim, p.T / jtr.N, jtr.chol,
                             jtr.dtype, antithetic=True)
    dWs = torch.from_numpy(np.swapaxes(np.asarray(dW), 0, 1).copy())
    ts = time_grid(POLISH_M, jtr.N, p.T, device="cpu").transpose(0, 1)
    return ts, dWs, CallOption1D(D=1).x0.expand(POLISH_M, 1)


def compare(seed: int) -> dict:
    p = JaxCall(D=1)
    bs = float(black_scholes_call(1.0, p.K, p.T, p.r, p.sigma_bar))
    kw = dict(M=256, N=10, layers=[2, 32, 32, 32, 32, 1], seed=seed)
    jtr = JaxTrainer(p, **kw)
    jtr.train(800, 1e-3, "Adam", log_every=400, verbose=False)
    jtr.train(200, 1e-4, "Adam", log_every=200, verbose=False)
    warm = float(jtr.y0_log[-1])
    tr = Trainer(CallOption1D(D=1), **kw, device="cpu")
    src = from_flax_params(jax.tree.map(np.asarray, jtr.params), "Sine", device="cpu")
    with torch.no_grad():
        for a, b in zip(tr.params.parameters(), src.parameters()):
            a.copy_(b)
    batch = _jax_polish_batch(jtr)
    jl = np.asarray(jtr.polish(n_iter=POLISH_STEPS, M=POLISH_M, seed=POLISH_SEED))
    tl = tr._polish_on(*batch, n_iter=POLISH_STEPS)
    jy, ty = float(jtr.y0_log[-1]), float(tr.y0_log[-1])
    return {"seed": seed, "black_scholes": bs, "warm_y0": warm, "warm_rel": abs(warm - bs) / bs,
            "jax_y0": jy, "jax_rel": abs(jy - bs) / bs, "port_y0": ty, "port_rel": abs(ty - bs) / bs,
            "jax_loss_first_last": [float(jl[0]), float(jl[-1])],
            "port_loss_first_last": [float(tl[0]), float(tl[-1])]}


def main(argv=None) -> int:
    for seed in (argv if argv is not None else sys.argv[1:]) or ["0"]:
        print(json.dumps(compare(int(seed))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
