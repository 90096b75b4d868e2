"""Ensemble training: K models trained simultaneously as one program, the
counterpart of ``dnnpde_tpu/train/ensemble.py``.

The members are the replicas of :class:`~dnnpde_tpu_torch.train.replicas.ReplicaProgram`
with their own learning rates: each member's gradient, clipping and
preconditioner state are its own (``vmap`` over the members), and the
learning rates are a (K,) device tensor. Member k of an ensemble built with
``seed`` is the port's solo ``Trainer(seed=seed + k)``: initial weights from
``torch.Generator().manual_seed(seed + k)`` on the CPU, increments (and a
stochastic net's noise) from a device generator seeded ``seed + k + 1``.
(The JAX package splits one key into the members' keys; threefry splits
have no torch counterpart, so the port names its member seeds.) Every member
starts from ``problem.x0``.

The per-iteration loss and Y0 of every member are written into a device
buffer at a device-side iteration index, and the n_iter iterations run as
one chunk (one captured iteration, replayed, on a CUDA device).

Meshes (the reference shards the member axis over chips) wait for ROADMAP.md
Queue 1, item 5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.solver.bsde import SolverConfig
from dnnpde_tpu_torch.train.replicas import PRECONDITIONERS, ReplicaProgram

_MESH_LATER = "is not ported yet (ROADMAP.md Queue 1, item 5: parallel/)"


@dataclasses.dataclass
class EnsembleResult:
    params: dict  # name -> (K, ...)
    losses: np.ndarray  # (K, n_iter)
    y0s: np.ndarray  # (K, n_iter)
    final_loss: np.ndarray  # (K,)


def _program(problem, K, M, N, layers, mode, activation, optimizer_type, clip_norm, seed,
             config, mesh, capacity, device) -> ReplicaProgram:
    if mesh is not None:
        raise NotImplementedError(f"ensemble training over a mesh {_MESH_LATER}")
    if optimizer_type.lower() not in PRECONDITIONERS:
        raise ValueError(f"ensemble supports {sorted(PRECONDITIONERS)}, got {optimizer_type!r}")
    layers = list(layers) if layers else [problem.dim + 1, 64, 64, 64, 64, 1]
    cfg = config or SolverConfig(remat=False, stochastic_net=mode.lower() == "sdenet")
    return ReplicaProgram(
        problem, [seed + k for k in range(K)], M=M, N=N, layers=layers, mode=mode,
        activation=activation, optimizer_type=optimizer_type, clip_norm=clip_norm,
        objective=cfg.objective, config=cfg, capacity=capacity, device=device)


def train_ensemble(
    problem: PDEProblem,
    n_members: int,
    n_iter: int,
    M: int = 64,
    N: int = 10,
    layers: Optional[Sequence[int]] = None,
    mode: str = "FC",
    activation: str = "Sine",
    learning_rates: float | Sequence[float] = 1e-3,
    optimizer_type: str = "Adam",
    clip_norm: float = 1.0,
    seed: int = 0,
    config: Optional[SolverConfig] = None,
    mesh=None,
    device=None,
) -> EnsembleResult:
    """Train ``n_members`` independently initialized models as one program.

    ``learning_rates``: one number (shared) or one per member, for lr
    sweeps. ``mesh`` raises NotImplementedError (ROADMAP.md Queue 1,
    item 5). ``device``: None = the first CUDA card (raises without one);
    "cpu" trains on the CPU.
    """
    prog = _program(problem, n_members, M, N, layers, mode, activation, optimizer_type,
                    clip_norm, seed, config, mesh, n_iter, device)
    prog.new_phase(np.broadcast_to(np.asarray(learning_rates, np.float32), (n_members,)).copy())
    prog.run(n_iter)
    losses, y0s = prog.logs(n_iter)
    return EnsembleResult(
        params={n: p.clone() for n, p in prog.params.items()},
        losses=losses.T.copy(), y0s=y0s.T.copy(), final_loss=losses[-1].copy())


def train_sensitivity_ensemble(
    problem: PDEProblem,
    hyperparams: Sequence[dict],
    M: int = 32,
    N: int = 16,
    layers: Optional[Sequence[int]] = None,
    mode: str = "FC",
    activation: str = "Sine",
    optimizer_type: str = "Adam",
    clip_norm: float = 1.0,
    seed: int = 0,
    iter_scale: float = 1.0,
    config: Optional[SolverConfig] = None,
    mesh=None,
    device=None,
) -> np.ndarray:
    """The min training loss of each hyperparameter sample, all samples
    trained as one two-phase program.

    Sample k trains ``initial_n_iter_k`` iterations at ``initial_lr_k``,
    then ``fine_tuning_n_iter_k`` at ``fine_tuning_lr_k`` (each scaled by
    ``iter_scale``, at least 1). Every member runs ``max(n1 + n2)``
    iterations: its rate switches at its own n1 on the device
    (``torch.where(i < n1, lr1, lr2)``), members past their budget keep
    stepping, and each member's loss counts only inside its own window (inf
    outside). Unlike a ``Trainer.train`` call per phase, the optimizer state
    carries across the switch, as in the reference's program. Returns the
    (K,) minima.
    """
    K = len(hyperparams)
    n1 = np.array([max(1, int(h["initial_n_iter"] * iter_scale)) for h in hyperparams])
    n2 = np.array([max(1, int(h["fine_tuning_n_iter"] * iter_scale)) for h in hyperparams])
    n_total = int((n1 + n2).max())
    prog = _program(problem, K, M, N, layers, mode, activation, optimizer_type, clip_norm,
                    seed, config, mesh, n_total, device)
    dev = prog.device

    def f32(values):
        return torch.tensor(np.asarray(values, np.float32), device=dev)

    prog.lr_switch = (torch.tensor(n1, dtype=torch.long, device=dev),
                      f32([h["initial_lr"] for h in hyperparams]),
                      f32([h["fine_tuning_lr"] for h in hyperparams]))
    prog.run(n_total)
    i = torch.arange(n_total, device=dev)[:, None]
    total = torch.tensor(n1 + n2, dtype=torch.long, device=dev)[None, :]
    losses = torch.where(i < total, prog.losses[:n_total], torch.inf)
    return losses.min(dim=0).values.cpu().numpy()
