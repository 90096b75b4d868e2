"""Closed-loop training: one ``Trainer``, ``Trainer.train`` in chunks of
``chunk`` iterations, each chunk's logs read back as a user's call does.

Set-up builds the trainer with the seed's weights and makes the window's
chunk (the buffers of ``chunk`` iterations) before its first call, so that
every iteration of the run goes through that one chunk and its one graph.
It then drives the trainer through its first ``check_steps`` iterations on
its own feed (the trainer's generator: every iteration draws new
increments, and X0 with a sampler): ``train(1)``, the chunk's eager warm-up
iteration, after which the first gradient is read as Adam got it (its first
moment over 1 − β₁); then ``train(check_steps − 1, log_every=1)``, which
captures the iteration into the chunk's CUDA graph and replays it: the
graph that the window replays. Each step's logged loss and the parameters
after the last step are read. These calls, to a synchronize, are
``capture_s``. The window runs chunks until ``--seconds`` have passed; the
rate is all its iterations over all its time.

The check follows the same steps with the plain reference from the same
weights and the same draws (``torch.Generator(device).manual_seed(s)``,
the trainer's generator, redrawn in the same order).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Optional

from benchmark import reference as ref
from benchmark.core.spec import sub_seed
from benchmark.drivers.common import leaf_norm_gap, load_mlp, port_problem, sync, weights
from benchmark.reference import bsde
from benchmark.reference.precision import matmul_mode

B1 = 0.9  # Adam's β₁


@dataclasses.dataclass
class State:
    trainer: object
    cfg: dict
    mix: dict
    host: dict
    program: dict
    chunk: object = None  # the window's chunk, made in set-up


def inputs(cfg: dict, mix: dict, seed: int, device) -> dict:
    Ws, bs = weights(cfg["layers"], seed, device)
    return {"Ws": Ws, "bs": bs, "trainer_seed": sub_seed(seed, "feed")}


def _leaves(params) -> list:
    """A net's parameters in the reference's layout: W_k (in, out), b_k."""
    return [p.detach().t().clone() if p.dim() == 2 else p.detach().clone() for p in params]


def _make_window_chunk(trainer, optimizer: str, lr: float, chunk: int):
    """Make the chunk of the window's calls before the first ``train`` call;
    returns it, or None for a trainer without the chunk cache. A later,
    shorter call reuses a chunk whose buffers hold as many iterations or more
    (``_get_chunk``), so the checked steps run on the window's chunk and
    capture its graph. The optimizer is selected first, since selecting the
    first one empties the cache (``_select_optimizer``)."""
    select = getattr(trainer, "_select_optimizer", None)
    make = getattr(trainer, "_get_chunk", None)
    if select is None or make is None:
        return None
    select(optimizer, lr)
    return make(trainer.N, optimizer, chunk)


def window_chunk_kept(state) -> bool:
    """Whether the trainer still holds the chunk made in set-up, and with it
    the graph that the checked steps captured."""
    cache = getattr(state.trainer, "_chunk_cache", {})
    return state.chunk is not None and any(c is state.chunk for c in cache.values())


def setup(cfg: dict, mix: dict, seed: int, device) -> State:
    from dnnpde_tpu_torch.sim import lognormal_x0
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    inp = inputs(cfg, mix, seed, device)
    problem = port_problem(cfg)
    tr = dict(cfg.get("trainer", {}))
    sampler = tr.pop("x0_sampler", None)
    if sampler is not None:
        tr["x0_sampler"] = lognormal_x0(problem.x0, sampler["scale"])
    solver = cfg.get("solver_config")
    trainer = Trainer(
        problem, M=mix["M"], N=cfg["N"], layers=cfg["layers"], mode=cfg["mode"],
        activation=cfg["activation"], seed=inp["trainer_seed"],
        solver_config=None if solver is None else SolverConfig(**solver),
        device=device, **tr)
    load_mlp(trainer.net, inp["Ws"], inp["bs"])
    opt, lr = cfg["optimizer"]["name"], cfg["optimizer"]["lr"]
    chunk = _make_window_chunk(trainer, opt, lr, mix["chunk"])
    t0 = time.perf_counter()
    start = _leaves(trainer.net.parameters())
    trainer.train(1, lr, opt, log_every=1, verbose=False)
    grad1 = [m.detach().clone() / (1.0 - B1) for m in trainer._opt_state["mu"]]
    trainer.train(mix["check_steps"] - 1, lr, opt, log_every=1, verbose=False)
    sync(device)
    host = {"capture_s": time.perf_counter() - t0}
    change = [p - s for p, s in zip(_leaves(trainer.net.parameters()), start)]
    if trainer.ema_decay is not None:
        change += [e - s for e, s in zip(_leaves(trainer.ema_params.parameters()), start)]
    program = {"losses": list(trainer.training_loss), "grad1": _leaves(grad1),
               "change": change}
    return State(trainer, cfg, mix, host, program, chunk)


def _note_chunk(state: State) -> None:
    if not window_chunk_kept(state):
        print("train: the window ran on another chunk than the checked steps", file=sys.stderr)


def _chunk(state: State, k: int) -> int:
    """One ``train`` call of k iterations; returns how many of them logged a
    non-finite loss."""
    opt = state.cfg["optimizer"]
    res = state.trainer.train(k, opt["lr"], opt["name"], log_every=k, verbose=False)
    return 0 if math.isfinite(float(res.graph[1][-1])) else k


def window(state: State, seconds: float):
    done = failed = 0
    t0 = time.perf_counter()
    while True:
        failed += _chunk(state, state.mix["chunk"])
        done += state.mix["chunk"]
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    _note_chunk(state)
    return {"train_it_per_s": (done / elapsed, "it/s")}, done, failed


def traced_window(state: State, traced) -> dict:
    """``trace_iterations`` iterations in one ``train`` call: replays of the
    window's captured iteration (the chunk's buffers hold as many or more)."""
    n = state.mix["trace_iterations"]
    with traced:
        failed = _chunk(state, n)
    _note_chunk(state)
    return {"iterations": n, "failed": failed}


def outputs(state: State) -> dict:
    return state.program


def reference(cfg: dict, mix: dict, inp: dict, precision: str = "f32",
              fault: Optional[str] = None) -> dict:
    problem = ref.problem(cfg["reference"]["module"], cfg["reference"].get("args", {}))
    device = inp["Ws"][0].device
    tr = cfg.get("trainer", {})
    batches = bsde.draws(inp["trainer_seed"] + 1, mix["check_steps"], mix["M"], cfg["N"],
                         problem.dim, problem.T, device, tr.get("x0_sampler"),
                         problem.x0(device))
    ts = bsde.time_grid(cfg["N"], problem.T, device)
    with matmul_mode(precision):
        return bsde.train_steps(problem, inp["Ws"], inp["bs"], batches, ts,
                                tr.get("objective", "global"), cfg["optimizer"]["lr"],
                                tr.get("ema_decay"), precision, fault)


def compare(program: dict, reference: dict) -> dict:
    losses = [abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"],
                                                   strict=True)]
    rule = reference["grad1"]
    n_params = len(rule)
    change_rule = rule * (len(reference["change"]) // n_params)
    return {
        "loss_gap": max(losses),
        "grad1_gap": leaf_norm_gap(program["grad1"], reference["grad1"], rule),
        "change_gap": leaf_norm_gap(program["change"], reference["change"], change_rule),
    }
