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

With ``mesh`` (``parallel.make_mesh``) the member axis goes over "dp", as
the reference shards it over chips: the rank at index r of "dp" runs members
r·K/dp … (r+1)·K/dp − 1 (the same seeds as unsharded) as one
``ReplicaProgram``, and the members' results are gathered on every rank by
one all-reduce each of a zero-filled (K, …) buffer into which each rank
writes its own rows (x + 0 is exact; gloo has no all-gather of CUDA
tensors). K must be divisible by the "dp" size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from dnnpde_tpu_torch.parallel.distributed import gather_rows
from dnnpde_tpu_torch.parallel.mesh import DP_AXIS, axis_size
from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.solver.bsde import SolverConfig
from dnnpde_tpu_torch.train.replicas import PRECONDITIONERS, ReplicaProgram

@dataclasses.dataclass
class EnsembleResult:
    params: dict  # name -> (K, ...)
    losses: np.ndarray  # (K, n_iter)
    y0s: np.ndarray  # (K, n_iter)
    final_loss: np.ndarray  # (K,)


def _shard_members(K: int, mesh) -> tuple[int, int]:
    """(first member, member count) of this rank's share of K members over
    the mesh's "dp" dim (all K without a mesh)."""
    if mesh is None:
        return 0, K
    n = axis_size(mesh, DP_AXIS)
    if K % n:
        raise ValueError(f"n_members={K} not divisible by dp={n}")
    k = K // n
    return mesh.get_local_rank(DP_AXIS) * k, k


def _gather_members(local: torch.Tensor, K: int, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's members of ``local`` (members along ``dim``), in member
    order, on every rank."""
    return local if mesh is None else gather_rows(local, K, mesh.get_group(DP_AXIS), dim)


def _program(problem, K, M, N, layers, mode, activation, optimizer_type, clip_norm, seed,
             config, mesh, capacity, device) -> tuple[ReplicaProgram, int, int]:
    """This rank's members as one program, with (first member, member
    count) of its share."""
    first, k = _shard_members(K, mesh)
    if optimizer_type.lower() not in PRECONDITIONERS:
        raise ValueError(f"ensemble supports {sorted(PRECONDITIONERS)}, got {optimizer_type!r}")
    layers = list(layers) if layers else [problem.dim + 1, 64, 64, 64, 64, 1]
    cfg = config or SolverConfig(remat=False, stochastic_net=mode.lower() == "sdenet")
    prog = ReplicaProgram(
        problem, [seed + first + j for j in range(k)], M=M, N=N, layers=layers, mode=mode,
        activation=activation, optimizer_type=optimizer_type, clip_norm=clip_norm,
        objective=cfg.objective, config=cfg, capacity=capacity, device=device)
    return prog, first, k


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
    sweeps. ``mesh``: the member axis over its "dp" dim (n_members
    divisible by its size). ``device``: None = the first CUDA card (raises without one);
    "cpu" trains on the CPU.
    """
    K = n_members
    prog, first, k = _program(problem, K, M, N, layers, mode, activation, optimizer_type,
                              clip_norm, seed, config, mesh, n_iter, device)
    lrs = np.broadcast_to(np.asarray(learning_rates, np.float32), (K,))
    prog.new_phase(lrs[first:first + k].copy())
    prog.run(n_iter)
    logs = [_gather_members(t[:n_iter], K, mesh, 1).cpu().numpy()
            for t in (prog.losses, prog.y0s)]
    return EnsembleResult(
        params={n: _gather_members(p.detach(), K, mesh).clone() for n, p in prog.params.items()},
        losses=logs[0].T.copy(), y0s=logs[1].T.copy(), final_loss=logs[0][-1].copy())


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
    prog, first, k = _program(problem, K, M, N, layers, mode, activation, optimizer_type,
                              clip_norm, seed, config, mesh, n_total, device)
    dev = prog.device
    mine = slice(first, first + k)

    def f32(values):
        return torch.tensor(np.asarray(values, np.float32)[mine], device=dev)

    prog.lr_switch = (torch.tensor(n1[mine], dtype=torch.long, device=dev),
                      f32([h["initial_lr"] for h in hyperparams]),
                      f32([h["fine_tuning_lr"] for h in hyperparams]))
    prog.run(n_total)
    i = torch.arange(n_total, device=dev)[:, None]
    total = torch.tensor((n1 + n2)[mine], dtype=torch.long, device=dev)[None, :]
    losses = torch.where(i < total, prog.losses[:n_total], torch.inf)
    return _gather_members(losses.min(dim=0).values, K, mesh).cpu().numpy()
