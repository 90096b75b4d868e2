"""Tolerance-gated benchmark harness, the counterpart of
``dnnpde_tpu/bench/harness.py``: the reference configurations as runnable,
oracle-gated rows.

Each row trains its problem at the reference's constants (the JAX
harness's, row by row), compares the learned Y0 against the row's oracle,
and reports wall time, throughput and the relative error. On a CUDA card
each training chunk is a replayed CUDA graph (``Trainer.train``).

    python -m dnnpde_tpu_torch.bench.harness [row ...]

runs the named rows (all five by default: bsb_100d, call_1d, basket_100d,
hjb_100d, heston) at their default budgets on the first CUDA card, prints
one JSON line per row (the ``BenchRow`` fields) and then the card's name
and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from dnnpde_tpu_torch.numerics import (
    HestonParams,
    basket_call_mc,
    black_scholes_call,
    bsb_exact_solution,
    heston_call_price,
    hjb_exact_mc,
)
from dnnpde_tpu_torch.pde import (
    BasketCallOption,
    BlackScholesBarenblatt,
    CallOption1D,
    HamiltonJacobiBellman,
    HestonPDE,
)
from dnnpde_tpu_torch.runtime import default_device
from dnnpde_tpu_torch.solver import make_net_u
from dnnpde_tpu_torch.train import Trainer


@dataclasses.dataclass
class BenchRow:
    name: str
    iters_per_sec: float
    paths_steps_per_sec: float
    learned_y0: float
    oracle_y0: float
    rel_error: float
    wall_time_s: float
    config: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _run(
    name: str,
    problem,
    oracle_y0: float,
    M: int,
    N: int,
    iters: tuple[int, int] | None = None,
    lrs: tuple[float, float] = (1e-3, 1e-5),
    phases: tuple[tuple[int, float], ...] | None = None,
    mode: str = "FC",
    activation: str = "Sine",
    layers=None,
    seed: int = 0,
    ema_decay: float | None = None,
    device=None,
) -> BenchRow:
    """Train through ``phases`` = ((n_iter, lr), ...); the legacy (iters,
    lrs) two-phase form is kept, with the default (2000, 500) when neither
    is given. A 100-iteration warm-up (which captures the chunk's graph on a
    card) runs outside the timed window. With ``ema_decay`` the headline
    ``learned_y0`` is the EMA shadow's u at (0, x0) and the raw tail average
    is kept in ``config["raw_tail_y0"]``."""
    if phases is None:
        if iters is None:
            iters = (2000, 500)
        phases = tuple(zip(iters, lrs))
    trainer = Trainer(
        problem, M=M, N=N, layers=layers, mode=mode, activation=activation,
        seed=seed, ema_decay=ema_decay, device=device,
    )
    trainer.train(100, phases[0][1], log_every=100, verbose=False)
    dev = trainer.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for n_it, lr in phases:
        trainer.train(n_it, lr, log_every=100, verbose=False)
    wall = time.perf_counter() - t0  # train() returns after reading its last logs
    total_iters = sum(n for n, _ in phases)
    # Y0 wobbles between log points: average the last phase's tail, never
    # reaching back into the phase before (each phase logs every 100)
    fine_logs = max(1, phases[-1][0] // 100)
    raw_tail = float(np.mean(trainer.y0_log[-min(3, fine_logs):]))
    extra_cfg = {}
    if ema_decay is not None:
        net_u = make_net_u(trainer.ema_params, transform=problem.transform_u)
        with torch.no_grad():
            u, _ = net_u(torch.zeros((1, 1), device=dev), problem.x0.to(dev)[None, :])
        learned = float(u[0, 0])
        extra_cfg = dict(ema_decay=ema_decay, raw_tail_y0=raw_tail)
    else:
        learned = raw_tail
    rel = abs(learned - oracle_y0) / max(abs(oracle_y0), 1e-12)
    return BenchRow(
        name=name,
        iters_per_sec=total_iters / wall,
        paths_steps_per_sec=total_iters * M * N / wall,
        learned_y0=float(learned),
        oracle_y0=float(oracle_y0),
        rel_error=float(rel),
        wall_time_s=wall,
        config=dict(M=M, N=N, D=problem.dim, mode=mode, activation=activation,
                    phases=[list(p) for p in phases], **extra_cfg),
    )


def bench_bsb_100d(iters=None, seed: int = 0, device=None) -> BenchRow:
    """100D BSB FC-Sine (oracle: closed form)."""
    p = BlackScholesBarenblatt(D=100)
    oracle = float(bsb_exact_solution(0.0, p.x0[None, :], T=p.T,
                                      device=default_device(device))[0, 0])
    return _run("bsb_100d_fc_sine", p, oracle, M=100, N=50, iters=iters,
                lrs=(1e-3, 1e-5), seed=seed, device=device)


def bench_call_1d(iters=None, seed: int = 0, device=None) -> BenchRow:
    """1D BS call (oracle: Black–Scholes). Default budget: the 20k-iteration
    four-phase anneal (1e-3 → 1e-6, 5k each); ``iters`` forces the legacy
    two-phase form."""
    p = CallOption1D(D=1)
    oracle = float(black_scholes_call(1.0, p.K, p.T, p.r, p.sigma_bar, device=device))
    phases = (
        None if iters is not None
        else ((5000, 1e-3), (5000, 1e-4), (5000, 1e-5), (5000, 1e-6))
    )
    return _run("call_1d_fc_sine", p, oracle, M=100, N=50, iters=iters,
                lrs=(1e-3, 1e-5), phases=phases, seed=seed, device=device)


def bench_basket_100d(iters=None, seed: int = 0, device=None) -> BenchRow:
    """100D basket call, NAIS-Net Sine (oracle: 200k-path MC)."""
    p = BasketCallOption(D=100)
    gen = torch.Generator(device=default_device(device)).manual_seed(0)
    mc, _ = basket_call_mc(gen, np.ones(100), p.strike, p.T, p.r, p.sigma_bar,
                           num_paths=200_000)
    return _run("basket_100d_naisnet_sine", p, float(mc), M=100, N=50,
                iters=iters, lrs=(1e-3, 1e-5), mode="Naisnet", seed=seed, device=device)


def bench_hjb_100d(iters=None, seed: int = 0, device=None) -> BenchRow:
    """100D HJB, NAIS-Net ReLU (oracle: 1e5-sample MC). Default: M = 128
    and a 20k three-phase anneal with the EMA read; ``iters`` gives the
    legacy reference-config row (M = 16, two phases)."""
    p = HamiltonJacobiBellman(D=100)
    gen = torch.Generator(device=default_device(device)).manual_seed(0)
    oracle = float(hjb_exact_mc(gen, 0.0, np.zeros(100)))
    if iters is not None:
        return _run("hjb_100d_naisnet_relu", p, oracle, M=16, N=50,
                    iters=iters, lrs=(1e-3, 1e-4), mode="Naisnet",
                    activation="ReLU", seed=seed, device=device)
    return _run(
        "hjb_100d_naisnet_relu", p, oracle, M=128, N=50,
        phases=((10000, 1e-3), (5000, 1e-4), (5000, 1e-5)),
        mode="Naisnet", activation="ReLU", seed=seed, ema_decay=0.999, device=device,
    )


def bench_heston(iters=None, seed: int = 0, device=None) -> BenchRow:
    """Heston M = 128 (oracle: the corrected closed form) with HestonPDE's
    defaults (Cholesky diffusion, the BS control-variate head). Default: a
    20k three-phase anneal with the EMA read; ``iters`` gives the legacy
    two-phase budget."""
    p = HestonPDE()
    oracle = float(heston_call_price(
        p.S0, p.v0,
        HestonParams(K=p.strike, r=p.r, T=p.T, kappa=p.kappa, theta=p.theta,
                     sigma=p.sigma_v, rho=p.rho, v0=p.v0),
        device=device,
    ))
    if iters is not None:
        return _run("heston_m128", p, oracle, M=128, N=50, iters=iters,
                    lrs=(1e-3, 1e-5), seed=seed, device=device)
    return _run(
        "heston_m128", p, oracle, M=128, N=50,
        phases=((10000, 1e-3), (5000, 1e-4), (5000, 1e-5)),
        seed=seed, ema_decay=0.999, device=device,
    )


ALL_BENCHES: dict[str, Callable[..., BenchRow]] = {
    "bsb_100d": bench_bsb_100d,
    "call_1d": bench_call_1d,
    "basket_100d": bench_basket_100d,
    "hjb_100d": bench_hjb_100d,
    "heston": bench_heston,
}


def run_all(iters=None, seed: int = 0, device=None) -> list[BenchRow]:
    """Every row at its own default budget when ``iters`` is None; a
    two-phase (n_initial, n_fine) forces a uniform quick sweep."""
    return [fn(iters=iters, seed=seed, device=device) for fn in ALL_BENCHES.values()]


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(ALL_BENCHES)
    unknown = [n for n in names if n not in ALL_BENCHES]
    if unknown:
        print(f"harness: unknown rows {unknown}; expected {list(ALL_BENCHES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("harness: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in names:
        print(json.dumps(ALL_BENCHES[name]().as_dict()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
