"""The port's data-parallel trainer (``Trainer(mesh=make_mesh(n))``) on gloo
ranks on the CPU, held against the port's unsharded trainer and JAX's
sharded one.

- ``__graft_entry__._dryrun_body``'s 12 configs at its sizes on 2 and 4
  ranks: each final loss and Y0 within 5e-5 relative of the unsharded
  trainer's (the dryrun's own bound), the 2-D config as dp × tp = n/2 × 2
  with its wide layers sharded, and the sharded checkpoint read back bit
  for bit, also by an unsharded trainer;
- every rank's parameters, Adam moments and EMA bitwise equal to the other
  ranks' (within one "tp" index on the 2-D mesh);
- the cases of ``tests/test_parallel.py`` (mesh shape, divisibility, the
  rows each rank trains on, six iterations against the unsharded trainer
  at its rtol 5e-4 and its parameters at rtol 1e-3 / atol 1e-5);
- BSB and Heston (full sigma, correlated increments) against JAX's own
  ``Trainer(mesh=make_mesh(8))`` from JAX's weights on JAX's increments:
  three iterations within 1e-5 relative each (as
  ``test_three_trainer_iterations_match_jax_on_its_increments``), weights
  and EMA within 3e-5.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dnnpde_tpu.parallel import make_mesh as jax_make_mesh
from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu.pde import HestonPDE as JaxHeston
from dnnpde_tpu.sim.brownian import brownian_increments as jax_increments
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch import parallel
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt, HestonPDE
from dnnpde_tpu_torch.train import Trainer
from torch_parallel_workers import dryrun_configs, run_job

PARITY_TOL = 5e-5  # _dryrun_body's assertion
CONFIGS = [*dryrun_configs(BlackScholesBarenblatt(D=8)), "dp_tp"]


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def dryrun(request, tmp_path_factory):
    return run_job("dryrun", request.param, tmp_path_factory.mktemp("dryrun"))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_twelve_configs_counted():
    assert len(CONFIGS) + 1 == 12  # the eleven training configs and the checkpoint


@pytest.mark.parametrize("name", CONFIGS)
def test_dryrun_config_matches_unsharded(dryrun, name):
    runs = dryrun[0]["parity"][name]
    (loss, y0), (ref_loss, ref_y0) = runs["sharded"], runs["unsharded"]
    assert np.isfinite(loss) and np.isfinite(ref_loss)
    assert _rel(loss, ref_loss) < PARITY_TOL, runs
    assert _rel(y0, ref_y0) < PARITY_TOL, runs
    assert all(r["parity"][name]["sharded"] == runs["sharded"] for r in dryrun)


@pytest.mark.parametrize("name", ["bf16_ema_antithetic", "heston_bs_local_ema_antithetic",
                                  "american_put", "heston_american_put", "bermudan_max_call",
                                  "dp_tp"])
def test_ranks_hold_bitwise_equal_state(dryrun, name):
    """Parameters, Adam moments and EMA equal bit for bit on every rank (on
    the 2-D mesh: on the ranks that hold the same "tp" shard)."""
    by_shard = {}
    for r in dryrun:
        by_shard.setdefault(r["tp_index"] if name == "dp_tp" else 0, []).append(r["states"][name])
    for states in by_shard.values():
        first = states[0]
        assert set(first) >= {"params", "mu", "nu"}
        for other in states[1:]:
            for key in first:
                assert all(torch.equal(a, b) for a, b in zip(first[key], other[key])), key


def test_2d_mesh_shards_the_wide_layers(dryrun):
    summary = dryrun[0]["tp_summary"]
    assert summary["dense.0.linear.weight"] == "Shard(dim=0)"  # JAX: P(None, "tp")
    assert summary["dense.1.linear.weight"] == "Shard(dim=1)"  # JAX: P("tp", None)
    assert summary["dense.2.linear.weight"] == "Replicate()"


def test_sharded_checkpoint_round_trip(dryrun):
    ck = dryrun[0]["checkpoint"]
    assert ck["same"] and all(r["checkpoint"]["same"] for r in dryrun)
    assert np.isfinite(ck["resumed"]).all()
    plain = Trainer(BlackScholesBarenblatt(D=8), M=8, N=4, layers=[9, 32, 32, 1], seed=7,
                    device="cpu")
    plain.load_model(ck["path"])
    assert all(torch.equal(a, b) for a, b in zip(plain._params, ck["params"]))


def test_collectives_are_counted_and_the_summary_has_jaxs_keys(dryrun):
    n = len(dryrun)
    for rank, r in enumerate(dryrun):
        assert r["collectives"] > 0
        assert r["summary"] == {"process_index": rank, "process_count": n,
                                "local_devices": 1, "global_devices": n}


def test_mesh_shape_and_checks(dryrun):
    n = len(dryrun)
    b = dryrun[0]["basics"]
    assert b["shape"] == {"dp": n}
    assert b["divisible"] == "" and "divisible" in b["indivisible"]
    assert "only" in b["too_many"] and "not supported" in b["too_few"]
    assert "divisible" in b["trainer_indivisible"]
    assert b["placement"].is_shard(0) and b["replicated"].is_replicate()
    assert b["multi_host"] and b["dp_backend"] == "gloo"


def test_each_rank_trains_its_rows(dryrun):
    """Each rank's loss sees M/n of the M paths (JAX: each device holds an
    (M/n, ·) shard of the batch)."""
    for r in dryrun:  # M = 4n paths, N = 4, D = 4
        assert r["basics"]["rows_seen"] == [((5, 4, 1), (4, 4, 4), (4, 4))]


def test_sharded_training_matches_unsharded(dryrun):
    b = dryrun[0]["basics"]
    np.testing.assert_allclose(b["losses"][1], b["losses"][0], rtol=5e-4)
    for a, c in zip(*b["params"]):
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-3, atol=1e-5)


def test_distributed_helpers_in_one_process():
    assert not parallel.is_multi_host()
    assert parallel.global_device_summary() == {
        "process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}
    with pytest.raises(RuntimeError, match="init_distributed"):
        parallel.make_mesh(1, devices="cpu")


# ----------------------------------------------------- against JAX's sharded trainer
JAX_CASES = {
    "bsb": (JaxBSB(D=8), BlackScholesBarenblatt(D=8),
            dict(M=8, N=4, layers=[9, 16, 16, 16, 1], seed=0, ema_decay=0.9)),
    "heston": (JaxHeston(clamp_output=True), HestonPDE(clamp_output=True),
               dict(M=8, N=4, layers=[3, 16, 16, 1], seed=0, ema_decay=0.9,
                    correlation_type="random_correlation")),
}


def _jax_draws(jtr, n_iter):
    """The increments (time-major) JAX's ``train(n_iter, log_every=1)`` draws."""
    key, out = jtr.key, []
    p = jtr.problem
    for _ in range(n_iter):
        key, sub = jax.random.split(key)
        (kk,) = jax.random.split(sub, 1)
        dW = jax_increments(jax.random.split(kk, 3)[0], jtr.M, jtr.N, p.noise_dim,
                            p.T / jtr.N, jtr.chol, jtr.dtype)
        out.append(torch.from_numpy(np.swapaxes(np.asarray(dW), 0, 1).copy()))
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_parity")
    inputs, ref = {}, {}
    for name, (jprob, prob, kw) in JAX_CASES.items():
        jtr = JaxTrainer(jprob, mesh=jax_make_mesh(8), **kw)
        weights = from_flax_params(jax.tree.map(np.asarray, jtr.params), "Sine", device="cpu")
        draws = _jax_draws(jtr, 3)
        res = jtr.train(3, 1e-3, log_every=1, verbose=False)
        ref[name] = {
            "losses": res.graph[1], "y0s": res.y0_history,
            **{k: dict(from_flax_params(jax.tree.map(np.asarray, tree), "Sine",
                                        device="cpu").named_parameters())
               for k, tree in (("params", jtr.params), ("ema", jtr.ema_params))}}
        inputs[name] = {"problem": prob, "trainer": kw, "draws": draws,
                        "weights": {k: v.detach() for k, v in weights.named_parameters()}}
    torch.save(inputs, tmp / "inputs.pt")
    return ref, run_job("jax_parity", 2, tmp)


def _close(actual, reference, tol):
    actual, reference = np.asarray(actual, np.float64), np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.abs(actual - reference).max() <= tol * (np.abs(reference).max() + 1e-30)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_trainer_matches_jax_sharded_trainer_on_its_draws(jax_runs, name):
    ref, ranks = jax_runs
    ours, theirs = ranks[0][name], ref[name]
    for i in range(3):
        _close(ours["losses"][i], theirs["losses"][i], 1e-5 * max(i, 1))
        _close(ours["y0s"][i], theirs["y0s"][i], 1e-5 * max(i, 1))
    for key in ("params", "ema"):
        for k, v in theirs[key].items():
            _close(ours[key][k].numpy(), v.detach().numpy(), 3e-5)
    assert np.array_equal(ranks[1][name]["losses"], ours["losses"])
