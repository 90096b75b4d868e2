"""The port's explicit-collective train step
(``parallel.make_shard_map_train_step``) on four gloo ranks on the CPU, the
cases of ``tests/test_shard_map.py``: the summed loss equal (1e-5
relative, as JAX's test) to one process's loss on the concatenation of
every rank's draws, the parameters moved and bitwise equal on every rank,
an indivisible batch rejected, and 30 steps lowering the loss."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dnnpde_tpu_torch.nets import build_network
from dnnpde_tpu_torch.parallel.shard_map_step import fold_in
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.sim.brownian import time_major_batch
from dnnpde_tpu_torch.solver import SolverConfig, make_loss_fn
from torch_parallel_workers import run_job

N_RANKS, M, N = 4, 16, 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_job("shard_map", N_RANKS, tmp_path_factory.mktemp("shard_map"))


def test_psum_loss_matches_global_computation(ranks):
    prob = BlackScholesBarenblatt(D=4)
    net = build_network("FC", [5, 16, 16, 16, 16, 1], "Sine", device="cpu")
    net.load_state_dict(ranks[0]["initial"])
    m_local = M // N_RANKS
    shards = [time_major_batch(torch.Generator().manual_seed(fold_in(7, r)), m_local, N,
                               prob.noise_dim, prob.T) for r in range(N_RANKS)]
    ts = torch.cat([s[0] for s in shards], dim=1)
    dWs = torch.cat([s[1] for s in shards], dim=1)
    X0 = prob.x0.expand(M, prob.dim)
    loss_fn = make_loss_fn(prob, net, SolverConfig())
    ref = float(loss_fn(net, ts, dWs, X0, paths=False).loss.detach())
    assert ranks[0]["losses"][0] == pytest.approx(ref, rel=1e-5)
    assert [r["index"] for r in ranks] == list(range(N_RANKS))


def test_step_updates_and_stays_replicated(ranks):
    first = ranks[0]
    assert all(np.isfinite(first["losses"]))
    assert any(not torch.allclose(first["initial"][k], v) for k, v in first["params"].items())
    for other in ranks[1:]:
        assert other["losses"] == first["losses"]
        assert all(torch.equal(v, other["params"][k]) for k, v in first["params"].items())


def test_indivisible_batch_raises(ranks):
    assert "not divisible" in ranks[0]["indivisible"]


def test_training_loop_reduces_loss(ranks):
    losses = ranks[0]["training"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_fold_in_streams_differ():
    seeds = {fold_in(s, r) for s in range(4) for r in range(4)}
    assert len(seeds) == 16 and all(0 <= x < 2**63 for x in seeds)
