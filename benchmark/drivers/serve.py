"""Served greeks: a closed loop of one client that waits for each answer, as
a risk engine waits for each revaluation.

Set-up exports the seed's net with ``export_solution``, writes the artifact
under ``TMPDIR`` and loads it with ``load_solution``; it builds on the card
a pool of ``pool`` states, t ~ U[0, 1], X = x0·exp(``x_scale``·N(0, 1)),
and sends one request of every size once. Request i takes B_i consecutive
states of the pool from offset o_i: the sizes are ``sizes`` values spaced
log-uniformly over [``b_min``, ``b_max``], each cycle of them in a new
order, so every seed sends the same sizes; the orders and offsets come from
the seed. A request is ``u_and_grad_device`` and a synchronize, timed by
the host clock. The window sends requests until ``--seconds`` have passed.

The check compares (u, Z) of ``sample`` requests drawn from the seed among
the first ``sample_of`` (sent after the window if it closed before them)
with the reference's (u, Z) on the same states.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from benchmark import reference as ref
from benchmark.core.spec import sub_seed
from benchmark.drivers.common import load_mlp, port_problem, rel_max_gap, sync, weights
from benchmark.reference.mlp import u_and_z
from benchmark.reference.precision import matmul_mode

# the artifact computes in f32 whatever the configuration trains in, so its
# control is the precision below f32
PRECISION = "f32"


@dataclasses.dataclass
class State:
    solution: object
    inp: dict
    mix: dict
    host: dict
    kept: dict  # sampled request index -> (u, Z)
    device: torch.device
    sent: int = 0  # requests sent so far


def _sizes(mix: dict) -> np.ndarray:
    k = mix["sizes"]
    q = (np.arange(k) + 0.5) / k
    return np.round(mix["b_min"] * (mix["b_max"] / mix["b_min"]) ** q).astype(np.int64)


def inputs(cfg: dict, mix: dict, seed: int, device) -> dict:
    """Weights, the pool, the request plan (sizes and offsets of the first
    ``plan`` requests) and the sampled request indices."""
    Ws, bs = weights(cfg["layers"], seed, device)
    D = cfg["layers"][0] - 1
    x0 = ref.problem(cfg["reference"]["module"], cfg["reference"].get("args", {})).x0(device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "pool"))
    P = mix["pool"]
    t = torch.rand((P, 1), generator=gen, device=device)
    X = x0.reshape(1, D) * torch.exp(mix["x_scale"] * torch.randn((P, D), generator=gen,
                                                                   device=device))
    rng = np.random.default_rng(sub_seed(seed, "plan"))
    sizes = _sizes(mix)
    cycles = -(-mix["plan"] // len(sizes))
    B = np.concatenate([rng.permutation(sizes) for _ in range(cycles)])[: mix["plan"]]
    off = rng.integers(0, P - B + 1)
    sample = np.sort(rng.choice(mix["sample_of"], size=mix["sample"], replace=False))
    return {"Ws": Ws, "bs": bs, "t": t, "X": X, "B": B, "off": off,
            "sample": frozenset(int(i) for i in sample)}


def setup(cfg: dict, mix: dict, seed: int, device) -> State:
    from dnnpde_tpu_torch.nets import MLP
    from dnnpde_tpu_torch.serve import export_solution, load_solution

    inp = inputs(cfg, mix, seed, device)
    net = MLP(cfg["layers"], cfg["activation"], device=device)
    load_mlp(net, inp["Ws"], inp["bs"])
    problem = port_problem(cfg)
    t0 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".pt2")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(export_solution(net, problem.dim))
        solution = load_solution(path, device=device)
    finally:
        os.remove(path)
    t1 = time.perf_counter()
    for b in _sizes(mix):  # every size once, with no request counted
        solution.u_and_grad_device(inp["t"][:b], inp["X"][:b])
    sync(device)
    host = {"export_and_load_s": t1 - t0, "warm_up_s": time.perf_counter() - t1}
    return State(solution, inp, mix, host, {}, torch.device(device))


def _request(state: State, dispatch: list | None = None) -> int:
    """Send the next request and wait for it; returns its size. With
    ``dispatch``, appends the host's time from the call to its return."""
    i = state.sent
    j = i % len(state.inp["B"])  # the plan repeats after its end
    b, o = int(state.inp["B"][j]), int(state.inp["off"][j])
    t, X = state.inp["t"][o:o + b], state.inp["X"][o:o + b]
    a = time.perf_counter()
    out = state.solution.u_and_grad_device(t, X)
    if dispatch is not None:
        dispatch.append(time.perf_counter() - a)
    sync(state.device)
    if i in state.inp["sample"]:
        state.kept[i] = out
    state.sent += 1
    return b


def _finish_sample(state: State) -> None:
    """Send, untimed, the requests up to the last sampled one."""
    while state.sent <= max(state.inp["sample"]):
        _request(state)


def window(state: State, seconds: float):
    lat, states = [], 0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        states += _request(state)
        end = time.perf_counter()
        lat.append(end - a)
        if end - t0 >= seconds:
            break
    elapsed = end - t0
    n = len(lat)
    _finish_sample(state)
    return ({"serve_states_per_s": (states / elapsed, "states/s"),
             "serve_p95_ms": (1e3 * float(np.percentile(lat, 95)), "ms")}, n, 0)


def traced_window(state: State, traced) -> dict:
    """One cycle of sizes timed for its dispatch alone (from the call to its
    return, the synchronize after it not counted), then one cycle traced."""
    k = state.mix["sizes"]
    dispatch = []
    for _ in range(k):
        _request(state, dispatch)
    state.host["dispatch_s"] = dispatch
    with traced:
        states = sum(_request(state) for _ in range(k))
    _finish_sample(state)
    return {"requests": k, "states": states, "failed": 0}


def outputs(state: State) -> dict:
    return {"kept": state.kept}


def reference(cfg: dict, mix: dict, inp: dict, precision: str = "f32") -> dict:
    out = {}
    with matmul_mode(precision):
        for i in inp["sample"]:
            b, o = int(inp["B"][i]), int(inp["off"][i])
            out[i] = u_and_z(inp["Ws"], inp["bs"], inp["t"][o:o + b], inp["X"][o:o + b],
                             precision, create_graph=False)
    return {"kept": out}


def compare(program: dict, reference: dict) -> dict:
    idx = sorted(reference["kept"])
    if sorted(program["kept"]) != idx:
        return {"u_gap": float("inf"), "z_gap": float("inf")}
    p, r = program["kept"], reference["kept"]
    return {"u_gap": rel_max_gap([p[i][0] for i in idx], [r[i][0] for i in idx]),
            "z_gap": rel_max_gap([p[i][1] for i in idx], [r[i][1] for i in idx])}
