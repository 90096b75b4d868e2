"""The explicit-collective data-parallel train step, the counterpart of
``dnnpde_tpu/parallel/shard_map_step.py``.

The Trainer's mesh path draws the global batch on every rank and keeps its
rows. This step is the explicit-SPMD alternative: each rank runs a local
program on its own M/dp paths, drawn from its own stream keyed by (seed,
rank) (``fold_in``, as JAX folds ``axis_index`` into its key), and the
reductions are written out: the local loss and gradients go into one flat
buffer, summed over "dp" by one all-reduce, and every rank applies the same
optimizer update to its (replicated) parameters.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from dnnpde_tpu_torch.parallel.distributed import all_reduce
from dnnpde_tpu_torch.parallel.mesh import DP_AXIS, axis_size
from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.sim.brownian import time_major_batch
from dnnpde_tpu_torch.solver.bsde import SolverConfig, make_loss_fn


def fold_in(seed: int, index: int) -> int:
    """The seed of stream ``index`` of ``seed``: a hash of the pair (the
    port's counterpart of ``jax.random.fold_in``)."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(index)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def make_shard_map_train_step(
    problem: PDEProblem,
    net: torch.nn.Module,
    tx,
    mesh,
    M: int,
    N: int,
    config: Optional[SolverConfig] = None,
    chol=None,
):
    """Build ``step(params, opt_state, seed) -> (params, opt_state, loss)``.

    ``params`` is the net (its parameters are updated in place, on every
    rank alike); ``tx`` is an optimizer of ``train.build_optimizer``. M is
    the GLOBAL batch: the rank at index r of "dp" simulates M/dp paths from a
    generator on the net's device seeded ``fold_in(seed, r)`` (increments,
    then a stochastic net's noise). The returned loss is the summed global
    loss."""
    n_dev = axis_size(mesh, DP_AXIS)
    if M % n_dev != 0:
        raise ValueError(f"global batch M={M} not divisible by {n_dev} devices")
    m_local = M // n_dev
    loss_fn = make_loss_fn(problem, net, config or SolverConfig())
    group = mesh.get_group(DP_AXIS)
    index = mesh.get_local_rank(DP_AXIS)
    dev = next(net.parameters()).device
    X0 = problem.x0.to(dev, torch.float32).expand(m_local, problem.dim)

    def step(params, opt_state, seed):
        plist = list(params.parameters())
        gen = torch.Generator(device=dev).manual_seed(fold_in(seed, index))
        ts, dWs = time_major_batch(gen, m_local, N, problem.noise_dim, problem.T, chol)
        noise = lambda shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
        res = loss_fn(params, ts, dWs, X0, paths=False, noise=noise)
        grads = torch.autograd.grad(res.loss, plist)
        flat = torch.cat([g.reshape(-1) for g in grads] + [res.loss.detach().reshape(1)])
        all_reduce(flat, group)
        grads = [v.view_as(g) for v, g in zip(flat[:-1].split([g.numel() for g in grads]),
                                               grads)]
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, plist)
            for p, u in zip(plist, updates):
                p.add_(u)
        return params, opt_state, flat[-1]

    return step
