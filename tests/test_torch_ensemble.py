"""The port's ensemble training (``train/ensemble.py``) on the CPU at a small
size: the cases of ``tests/test_ensemble.py`` (shapes, the lr sweep ordering
convergence, LBFGS rejected, the two-phase masking), member k against the
port's solo ``Trainer(seed=seed + k)`` (per-iteration Y0 within 1e-5 of
max|·|), the sensitivity program's phase switch against a one-member
program stepped by hand (bitwise), and the executor's one ensemble call."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dnnpde_tpu_torch.pde import BlackScholesBarenblatt, CallOption1D
from dnnpde_tpu_torch.train import (
    ReplicaProgram,
    Trainer,
    train_ensemble,
    train_sensitivity_ensemble,
)

LAYERS = [5, 16, 16, 16, 16, 1]
HPS = [
    {"initial_lr": 1e-3, "fine_tuning_lr": 1e-4, "initial_n_iter": 60, "fine_tuning_n_iter": 20},
    {"initial_lr": 1e-7, "fine_tuning_lr": 1e-8, "initial_n_iter": 10, "fine_tuning_n_iter": 5},
    {"initial_lr": 3e-3, "fine_tuning_lr": 1e-5, "initial_n_iter": 30, "fine_tuning_n_iter": 40},
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ensemble_shapes_and_training():
    res = train_ensemble(BlackScholesBarenblatt(D=4), n_members=3, n_iter=30, M=16, N=4,
                         layers=LAYERS, learning_rates=1e-3, device="cpu")
    assert res.losses.shape == res.y0s.shape == (3, 30)
    assert res.final_loss.shape == (3,) and np.array_equal(res.final_loss, res.losses[:, -1])
    assert np.isfinite(res.losses).all()
    assert not np.allclose(res.losses[0], res.losses[1])  # independent members
    assert res.losses[:, -5:].mean() < res.losses[:, :5].mean()
    assert all(v.shape[0] == 3 for v in res.params.values())


def test_ensemble_lr_sweep_orders_convergence():
    res = train_ensemble(BlackScholesBarenblatt(D=4), n_members=2, n_iter=60, M=16, N=4,
                         layers=LAYERS, learning_rates=[1e-5, 1e-3], device="cpu")
    assert res.final_loss[1] < res.final_loss[0]


def test_ensemble_rejects_unknown_optimizer_and_meshes():
    with pytest.raises(ValueError, match="ensemble supports"):
        train_ensemble(BlackScholesBarenblatt(D=2), 2, 2, M=4, N=2, layers=[3, 8, 8, 8, 8, 1],
                       optimizer_type="LBFGS", device="cpu")
    with pytest.raises(ValueError, match="ensemble supports"):
        train_sensitivity_ensemble(BlackScholesBarenblatt(D=2), HPS, M=4, N=2,
                                   layers=[3, 8, 1], optimizer_type="LBFGS", device="cpu")
    # a mesh whose "dp" size does not divide the members is rejected before
    # any collective (the sharded ensemble itself: tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="divisible"):
        train_ensemble(BlackScholesBarenblatt(D=2), 3, 2, M=4, N=2, mesh=_DpMesh(2),
                       device="cpu")


class _DpMesh:
    """The face of a 1-D "dp" mesh of ``n`` ranks that the member split reads."""

    mesh_dim_names = ("dp",)

    def __init__(self, n):
        self.n = n

    def size(self, dim):
        return self.n


def test_ensemble_member_k_is_the_solo_trainer_of_seed_plus_k():
    prob = CallOption1D(D=1)
    res = train_ensemble(prob, n_members=2, n_iter=12, M=8, N=4, layers=[2, 16, 16, 1],
                         learning_rates=[1e-3, 2e-3], seed=2, device="cpu")
    for k, lr in enumerate((1e-3, 2e-3)):
        tr = Trainer(prob, M=8, N=4, layers=[2, 16, 16, 1], seed=2 + k, device="cpu")
        tr.train(12, lr, log_every=1, verbose=False)
        ref = np.asarray(tr.y0_log)
        assert np.abs(res.y0s[k] - ref).max() <= 1e-5 * np.abs(ref).max()


def test_sensitivity_ensemble_two_phase_masking():
    prob = BlackScholesBarenblatt(D=4)
    perfs = train_sensitivity_ensemble(prob, HPS, M=16, N=4, layers=LAYERS, seed=0,
                                       device="cpu")
    assert perfs.shape == (3,) and np.isfinite(perfs).all()
    assert perfs[0] < perfs[1]  # a longer budget at a working lr beats a junk lr

    # the same program, its per-iteration losses reduced by hand: each
    # member's minimum over its own window only
    prog = ReplicaProgram(prob, (0, 1, 2), M=16, N=4, layers=LAYERS, capacity=80,
                          device="cpu")
    n1 = torch.tensor([60, 10, 30])
    prog.lr_switch = (n1, torch.tensor([1e-3, 1e-7, 3e-3]), torch.tensor([1e-4, 1e-8, 1e-5]))
    prog.run(80)
    losses, _ = prog.logs(80)
    hand = [losses[:n, k].min() for k, n in enumerate((80, 15, 70))]
    assert np.array_equal(perfs, np.asarray(hand, np.float32))
    assert np.isfinite(losses[15:, 1]).all()  # past its budget the member kept stepping


def test_sensitivity_switch_is_the_member_own_phase_boundary():
    """Member 1 of the sensitivity program steps at 1e-7 for 10 iterations,
    then at 1e-8, with the optimizer state carried across the switch: a
    one-member program stepped so by hand takes the same iterations, bit for
    bit."""
    prob = BlackScholesBarenblatt(D=4)
    prog = ReplicaProgram(prob, (0, 1, 2), M=16, N=4, layers=LAYERS, capacity=15,
                          device="cpu")
    prog.lr_switch = (torch.tensor([60, 10, 30]), torch.tensor([1e-3, 1e-7, 3e-3]),
                      torch.tensor([1e-4, 1e-8, 1e-5]))
    prog.run(15)
    solo = ReplicaProgram(prob, (1,), M=16, N=4, layers=LAYERS, capacity=10, device="cpu")
    solo.new_phase(1e-7)
    solo.run(10)
    first, _ = solo.logs(10)
    solo.lr.fill_(1e-8)
    solo.run(5)
    second, _ = solo.logs(5)
    assert np.array_equal(prog.logs(15)[0][:, 1], np.concatenate([first[:, 0], second[:, 0]]))
    assert int(solo.opt_state["count"][0]) == 15


def test_sensitivity_executor_uses_one_ensemble_call(monkeypatch):
    from dnnpde_tpu_torch.experiments import SensitivityExecutor
    import dnnpde_tpu_torch.train.ensemble as ens

    calls = []
    orig = ens.train_sensitivity_ensemble

    def spy(problem, hyperparams, **kw):
        calls.append(len(hyperparams))
        return orig(problem, hyperparams, **kw)

    monkeypatch.setattr(ens, "train_sensitivity_ensemble", spy)
    scores = SensitivityExecutor(CallOption1D(D=1), M=4, N=3, iter_scale=2e-4,
                                 device="cpu").execute(num_real_samples=3,
                                                       num_simulated_samples=50)
    assert calls == [3]
    assert set(scores) == {"initial_lr", "fine_tuning_lr", "initial_n_iter", "fine_tuning_n_iter"}
    assert all(np.isfinite(v) for v in scores.values())


def test_sensitivity_executor_falls_back_to_sequential_runs(monkeypatch):
    from dnnpde_tpu_torch.experiments import SensitivityExecutor
    import dnnpde_tpu_torch.train.ensemble as ens

    monkeypatch.setattr(ens, "train_sensitivity_ensemble",
                        lambda *a, **kw: pytest.fail("LBFGS is not an ensemble optimizer"))
    ex = SensitivityExecutor(CallOption1D(D=1), M=4, N=3, optimizer="LBFGS", iter_scale=2e-4,
                             device="cpu")
    seen = []
    monkeypatch.setattr(ex, "evaluate_model", lambda hp: seen.append(hp) or 1.0)
    scores = ex.execute(num_real_samples=2, num_simulated_samples=20)
    assert len(seen) == 2 and all(np.isfinite(v) for v in scores.values())
    monkeypatch.undo()
    hp = {"initial_lr": 1e-3, "fine_tuning_lr": 1e-4, "initial_n_iter": 10000,
          "fine_tuning_n_iter": 5000}
    assert np.isfinite(SensitivityExecutor(CallOption1D(D=1), M=4, N=3, iter_scale=2e-4,
                                           device="cpu").evaluate_model(hp))


@pytest.fixture(scope="module")
def sharded_ensemble(tmp_path_factory):
    from torch_parallel_workers import run_job

    return run_job("ensemble", 4, tmp_path_factory.mktemp("ensemble"))


def test_ensemble_mesh_sharded_matches_unsharded(sharded_ensemble):
    """``tests/test_ensemble.py``'s case: 8 members over a 4-rank "dp" mesh
    (two a rank) against the unsharded ensemble at its rtol 1e-4; every
    rank gathers the same (K, ...) results."""
    from torch_parallel_workers import ENSEMBLE

    plain = train_ensemble(BlackScholesBarenblatt(D=4), **ENSEMBLE)
    ours = sharded_ensemble[0]
    np.testing.assert_allclose(ours["losses"], plain.losses, rtol=1e-4)
    np.testing.assert_allclose(ours["y0s"], plain.y0s, rtol=1e-4)
    for name, p in plain.params.items():
        np.testing.assert_allclose(ours["params"][name].numpy(), p.numpy(), rtol=1e-4,
                                   atol=1e-6)
    for other in sharded_ensemble[1:]:
        assert np.array_equal(other["losses"], ours["losses"])
        assert all(torch.equal(v, other["params"][k]) for k, v in ours["params"].items())


def test_ensemble_mesh_divisibility_error(sharded_ensemble):
    assert "divisible" in sharded_ensemble[0]["indivisible"]


def test_sensitivity_ensemble_over_a_mesh_matches_unsharded(sharded_ensemble):
    from torch_parallel_workers import SENSITIVITY_HPS

    plain = train_sensitivity_ensemble(BlackScholesBarenblatt(D=4), SENSITIVITY_HPS, M=8, N=4,
                                       layers=[5, 16, 16, 1], device="cpu")
    np.testing.assert_allclose(sharded_ensemble[0]["sensitivity"], plain, rtol=1e-4)
