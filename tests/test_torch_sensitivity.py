"""The port's hyperparameter sensitivity analysis (``evals/sensitivity.py``)
and ``SensitivityExecutor`` against the JAX package's, on the CPU.

- ``hsic_rbf`` within 1e-5 relative of JAX's at even and odd n. At an even
  n the median of the n² distances is the mean of the two middle ones, as
  ``jnp.median`` takes it: the lower middle value (``torch.median``) moves
  the estimate by more than that bound on these inputs (checked below).
- ``spearman_rank_correlation`` exactly; ``sample_hyperparameters`` and
  ``simulate_performance`` bitwise from the same numpy generator.
- ``FastSensitivityAnalysis.run`` (scikit-learn present): HSIC within 1e-5
  relative, rank correlations and permutation importances exactly.
- ``SensitivityExecutor`` at ``tests/test_executors.py``'s sizes: the four
  scores, finite; with no real samples (so no training, whose Brownian
  streams differ between the packages) each score within 1e-5 of JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dnnpde_tpu.evals import sensitivity as jsens
from dnnpde_tpu.experiments import SensitivityExecutor as JaxSensitivityExecutor
from dnnpde_tpu.pde import CallOption1D as JaxCall1D
from dnnpde_tpu_torch.evals import sensitivity as sens
from dnnpde_tpu_torch.experiments import SensitivityExecutor
from dnnpde_tpu_torch.pde import CallOption1D


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with several test workers on one host, PyTorch's
    default of one thread per core makes these small CPU ops many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = {"initial_lr", "fine_tuning_lr", "initial_n_iter", "fine_tuning_n_iter"}


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("n", [200, 201])
def test_hsic_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(-1, 1, n)
    for y in (x**2 + 0.05 * rng.standard_normal(n), rng.standard_normal(n)):
        assert _rel(sens.hsic_rbf(x, y, device="cpu"), jsens.hsic_rbf(x, y)) <= 1e-5


def test_hsic_takes_the_mean_of_the_two_middle_distances(monkeypatch):
    """The lower middle distance as the bandwidth (``torch.median``) misses
    JAX's HSIC by more than the 1e-5 bound at this even n."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, 40)
    y = x**2 + 0.05 * rng.standard_normal(40)
    ref = jsens.hsic_rbf(x, y)
    assert _rel(sens.hsic_rbf(x, y, device="cpu"), ref) <= 1e-5
    monkeypatch.setattr(torch, "quantile", lambda v, q: torch.median(v))
    assert _rel(sens.hsic_rbf(x, y, device="cpu"), ref) > 1e-5


def test_hsic_detects_dependence():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 200)
    dep = sens.hsic_rbf(x, x**2 + 0.01 * rng.standard_normal(200), device="cpu")
    assert dep > 5 * sens.hsic_rbf(x, rng.standard_normal(200), device="cpu")


def test_spearman_sampling_and_simulation_match_jax_exactly():
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal(60), rng.standard_normal(60)
    assert sens.spearman_rank_correlation(x, y) == jsens.spearman_rank_correlation(x, y)
    assert sens.spearman_rank_correlation(x, -x) == pytest.approx(-1.0)
    ours, ref = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(20):
        hp = sens.sample_hyperparameters(ours)
        assert hp == jsens.sample_hyperparameters(ref)
        arrays = {k: np.asarray(v) for k, v in hp.items()}
        assert sens.simulate_performance(arrays, ours) == jsens.simulate_performance(arrays, ref)


def test_analyzer_ranks_initial_lr_in_the_top_two():
    rng = np.random.default_rng(1)
    results = []
    for _ in range(200):
        hp = sens.sample_hyperparameters(rng)
        perf = float(sens.simulate_performance({k: np.asarray(v) for k, v in hp.items()}, rng))
        results.append({"hyperparams": hp, "performance": perf})
    scores, hp, perf = sens.SensitivityAnalyzer(device="cpu").analyze(results)
    ref, _, _ = jsens.SensitivityAnalyzer().analyze(results)
    assert set(scores) == NAMES and hp["initial_lr"].shape == perf.shape == (200,)
    assert "initial_lr" in sorted(scores, key=scores.get, reverse=True)[:2]
    assert all(_rel(scores[k], ref[k]) <= 1e-5 for k in NAMES)


def test_fast_sensitivity_analysis_matches_jax():
    ours = sens.FastSensitivityAnalysis(num_samples=300, seed=2, device="cpu").run()
    ref = jsens.FastSensitivityAnalysis(num_samples=300, seed=2).run()
    assert set(ours) == set(ref) == {"hsic", "rank_correlation", "permutation_importance"}
    assert all(_rel(ours["hsic"][k], ref["hsic"][k]) <= 1e-5 for k in NAMES)
    assert ours["rank_correlation"] == ref["rank_correlation"]
    assert ours["permutation_importance"] == ref["permutation_importance"]


def test_sensitivity_executor_at_the_reference_test_sizes():
    scores = SensitivityExecutor(CallOption1D(D=1), M=4, N=3, iter_scale=2e-4,
                                 device="cpu").execute(num_real_samples=2,
                                                       num_simulated_samples=100)
    assert set(scores) == NAMES and all(np.isfinite(v) for v in scores.values())
    ours = SensitivityExecutor(CallOption1D(D=1), M=4, N=3, device="cpu", seed=4).execute(
        num_real_samples=0, num_simulated_samples=150)
    ref = JaxSensitivityExecutor(JaxCall1D(D=1), M=4, N=3, seed=4).execute(
        num_real_samples=0, num_simulated_samples=150)
    assert all(_rel(ours[k], ref[k]) <= 1e-5 for k in NAMES)
