"""Learned-solution paths for a P&L distribution: a closed loop of
``predict_paths_fast(trainer, M, seed=k)``, each result read back to the
host before the next request is sent.

Set-up builds the trainer with the seed's weights and sends one request.
Request i draws its increments in the kernel from its own 64-bit seed k_i,
derived from the run's seed. The window sends requests until ``--seconds``
have passed; the rate is all the paths returned over all its time.

The check compares the Y paths of ``sample`` requests drawn from the seed
among the first ``sample_of`` (sent after the window if it closed before
them) with the reference's paths on the same Philox stream.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark import reference as ref
from benchmark.core.spec import sub_seed
from benchmark.drivers.common import load_mlp, port_problem, rel_max_gap, weights
from benchmark.reference import rollout


@dataclasses.dataclass
class State:
    trainer: object
    inp: dict
    mix: dict
    host: dict
    kept: dict  # sampled request index -> Y on the host
    sent: int = 0


def _request_seed(seed: int, i: int) -> int:
    return sub_seed(seed, f"request {i}")


def inputs(cfg: dict, mix: dict, seed: int, device) -> dict:
    Ws, bs = weights(cfg["layers"], seed, device)
    rng = np.random.default_rng(sub_seed(seed, "plan"))
    sample = rng.choice(mix["sample_of"], size=mix["sample"], replace=False)
    return {"Ws": Ws, "bs": bs, "seed": seed, "sample": frozenset(int(i) for i in sample)}


def setup(cfg: dict, mix: dict, seed: int, device) -> State:
    from dnnpde_tpu_torch.ops.rollout_kernel import predict_paths_fast
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    inp = inputs(cfg, mix, seed, device)
    solver = cfg.get("solver_config")
    trainer = Trainer(
        port_problem(cfg), M=mix["M"], N=cfg["N"], layers=cfg["layers"], mode=cfg["mode"],
        activation=cfg["activation"], seed=sub_seed(seed, "feed"),
        solver_config=None if solver is None else SolverConfig(**solver), device=device)
    load_mlp(trainer.net, inp["Ws"], inp["bs"])
    predict_paths_fast(trainer, M=mix["M"], seed=_request_seed(seed, -1)).cpu()
    return State(trainer, inp, mix, {}, {})


def _request(state: State) -> int:
    from dnnpde_tpu_torch.ops.rollout_kernel import predict_paths_fast

    i, M = state.sent, state.mix["M"]
    Y = predict_paths_fast(state.trainer, M=M, seed=_request_seed(state.inp["seed"], i)).cpu()
    if i in state.inp["sample"]:
        state.kept[i] = Y
    state.sent += 1
    return M


def _finish_sample(state: State) -> None:
    while state.sent <= max(state.inp["sample"]):
        _request(state)


def window(state: State, seconds: float):
    paths = n = 0
    t0 = time.perf_counter()
    while True:
        paths += _request(state)
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    _finish_sample(state)
    return {"paths_per_s": (paths / elapsed, "paths/s")}, n, 0


def traced_window(state: State, traced) -> dict:
    k = state.mix["trace_requests"]
    with traced:
        for _ in range(k):
            _request(state)
    _finish_sample(state)
    return {"requests": k, "paths": k * state.mix["M"], "failed": 0}


def outputs(state: State) -> dict:
    return {"kept": state.kept}


def reference(cfg: dict, mix: dict, inp: dict, precision: str = "f32") -> dict:
    problem = ref.problem(cfg["reference"]["module"], cfg["reference"].get("args", {}))
    device = inp["Ws"][0].device
    mu_c, sig_c = problem.gbm
    out = {i: rollout.paths(inp["Ws"], inp["bs"], problem.x0(device), mu_c, sig_c, cfg["N"],
                            problem.T, mix["M"], _request_seed(inp["seed"], i), precision)
           for i in sorted(inp["sample"])}
    return {"kept": out}


def compare(program: dict, reference: dict) -> dict:
    idx = sorted(reference["kept"])
    if sorted(program["kept"]) != idx:
        return {"y_gap": float("inf")}
    return {"y_gap": rel_max_gap([program["kept"][i] for i in idx],
                                 [reference["kept"][i] for i in idx])}
