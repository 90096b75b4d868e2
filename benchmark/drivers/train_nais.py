"""Closed-loop training of a NAIS-Net: ``drivers/train.py``'s loop, window,
trace and check, with the NAIS-Net's weights.

``inputs`` draws the leaves of the port's ``NaisNet`` from the seed, in the
order of its ``parameters()`` (the input layer, every block's kernel and
bias, every input injection's, the head): Xavier-uniform matrices in the
(in, out) layout and biases U(−0.1, 0.1), as ``drivers/common.py::weights``
draws an MLP's. ``setup`` loads them into the trainer's net and runs the
checked steps as ``train.setup`` does; ``reference`` runs the same steps with
``reference/naisnet.py``'s net through ``reference/training.py``.

The check differs from ``train.compare``. At some seeds this net's first
gradient moves by a few percent when its weights are rounded to bf16, and
the steps after the first by tens of percent (the reference's own bf16 run
moves as far from its f32 run as the program does), which a gap to the f32
run alone cannot tell from the fp8 control or from half the batch. So the
f32 reference also runs the steps with its matmul operands in the
configuration's precision (``at_precision``), and each number is the
program's gap to the nearer of the two runs: the worst step's relative loss
gap (``loss_gap``), the first gradient's distance by the worst leaf
(``grad1_dist``: ‖program − reference‖ over the larger of the leaf's and the
median leaf's reference norm), and the norm gap of the steps' change
(``change_gap``, as ``train.compare``'s).
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

from benchmark import reference as ref
from benchmark.core.spec import sub_seed
from benchmark.drivers.common import BIAS_SCALE, leaf_norm_gap, port_problem, sync
from benchmark.drivers.train import (  # noqa: F401  (the loop and window are train's)
    B1, State, _leaves, _make_window_chunk, outputs, traced_window, window, window_chunk_kept,
)
from benchmark.reference import bsde, naisnet, training
from benchmark.reference.precision import matmul_mode


def shapes(layers) -> list[tuple[int, int]]:
    """The (in, out) shapes of a NAIS-Net's matrices in ``parameters()``
    order, for widths [n0, H, ..., H, n_out]."""
    n0, H, blocks = layers[0], layers[1], len(layers) - 3
    return [(n0, H)] + [(H, H)] * blocks + [(n0, H)] * blocks + [(H, layers[-1])]


def weights(layers, seed: int, device) -> tuple[list, list]:
    """Xavier-uniform matrices and biases U(−0.1, 0.1), f32, drawn on
    ``device`` from ``seed`` in one call."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    mats = shapes(layers)
    sizes = [a * b for a, b in mats] + [b for _, b in mats]
    u = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    parts = u.split(sizes)
    Ws = [(parts[k] * (6.0 / (a + b)) ** 0.5).reshape(a, b) for k, (a, b) in enumerate(mats)]
    bs = [parts[len(mats) + k] * BIAS_SCALE for k in range(len(mats))]
    return Ws, bs


def load_nais(net, Ws, bs) -> None:
    """Copy the leaves into a port ``NaisNet``'s parameters, in place."""
    leaves = [p for pair in zip(Ws, bs) for p in pair]
    with torch.no_grad():
        for p, v in zip(net.parameters(), leaves, strict=True):
            p.copy_(v.T if v.dim() == 2 else v)


def inputs(cfg: dict, mix: dict, seed: int, device) -> dict:
    Ws, bs = weights(cfg["layers"], seed, device)
    return {"Ws": Ws, "bs": bs, "trainer_seed": sub_seed(seed, "feed")}


def setup(cfg: dict, mix: dict, seed: int, device) -> State:
    from dnnpde_tpu_torch.solver import SolverConfig
    from dnnpde_tpu_torch.train import Trainer

    inp = inputs(cfg, mix, seed, device)
    solver = cfg.get("solver_config")
    trainer = Trainer(
        port_problem(cfg), M=mix["M"], N=cfg["N"], layers=cfg["layers"], mode=cfg["mode"],
        activation=cfg["activation"], seed=inp["trainer_seed"],
        solver_config=None if solver is None else SolverConfig(**solver),
        device=device, **cfg.get("trainer", {}))
    load_nais(trainer.net, inp["Ws"], inp["bs"])
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
    program = {"losses": list(trainer.training_loss), "grad1": _leaves(grad1),
               "change": change}
    return State(trainer, cfg, mix, host, program, chunk)


def reference(cfg: dict, mix: dict, inp: dict, precision: str = "f32",
              fault: Optional[str] = None) -> dict:
    problem = ref.problem(cfg["reference"]["module"], cfg["reference"].get("args", {}))
    device = inp["Ws"][0].device
    batches = bsde.draws(inp["trainer_seed"] + 1, mix["check_steps"], mix["M"], cfg["N"],
                         problem.dim, problem.T, device, x0=problem.x0(device))
    ts = bsde.time_grid(cfg["N"], problem.T, device)

    def steps(precision: str, fault: Optional[str]) -> dict:
        with matmul_mode(precision):
            return training.train_steps(
                problem, naisnet.u_and_z, inp["Ws"], inp["bs"], batches, ts,
                cfg.get("trainer", {}).get("objective", "global"), cfg["optimizer"]["lr"],
                precision=precision, fault=fault)

    out = steps(precision, fault)
    if precision == "f32" and fault is None:
        out["at_precision"] = steps(cfg["precision"], None)
    return out


def leaf_distance(program: list, reference: list, rule: list) -> float:
    """The worst leaf's ‖program − reference‖ over the larger of that leaf's
    ‖reference‖ and the median leaf's, over the leaves that
    ``common.leaf_norm_gap`` keeps (``rule``: the reference's first
    gradient)."""
    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    rule_norms = [norm(g) for g in rule]
    floor = 1e-3 * statistics.median(rule_norms)
    pairs = [(norm(p.to(r.device) - r), norm(r))
             for p, r, n in zip(program, reference, rule_norms, strict=True) if n >= floor]
    median = statistics.median(r for _, r in pairs)
    return max(d / max(r, median) for d, r in pairs)


def compare(program: dict, reference: dict) -> dict:
    """The program's gaps to the nearer of the reference's two runs, in f32
    and in the configuration's precision (the module's docstring)."""
    runs = [reference, reference["at_precision"]]

    def nearest(gap) -> float:
        return min(gap(r) for r in runs)

    return {
        "loss_gap": nearest(lambda r: max(
            abs(a - b) / abs(b) for a, b in zip(program["losses"], r["losses"], strict=True))),
        "grad1_dist": nearest(lambda r: leaf_distance(program["grad1"], r["grad1"], r["grad1"])),
        "change_gap": nearest(lambda r: leaf_norm_gap(program["change"], r["change"], r["grad1"])),
    }
