"""The port's results reports and stability analysis against the JAX
package's: ``quality_row``'s flags equal; the CSV of the same rows equal to
JAX's byte for byte and read back by pandas into equal frames; and
``StabilityCheck``'s perturbation errors, spectral radii and (smoothed)
Jacobian surfaces within 1e-4 relative of JAX's on weights carried across
from a JAX trainer, on the same states and paths."""

from __future__ import annotations

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from dnnpde_tpu.evals import StabilityCheck as JaxStabilityCheck
from dnnpde_tpu.evals.reports import RESULT_COLUMNS as JAX_RESULT_COLUMNS
from dnnpde_tpu.evals.reports import ResultsReport as JaxResultsReport
from dnnpde_tpu.evals.reports import quality_row as jax_quality_row
from dnnpde_tpu.pde import BlackScholesBarenblatt as JaxBSB
from dnnpde_tpu.train import Trainer as JaxTrainer
from dnnpde_tpu_torch.evals import RESULT_COLUMNS, ResultsReport, StabilityCheck, quality_row
from dnnpde_tpu_torch.params import from_flax_params
from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.train import Trainer

ROWS = [
    {"kind": "iv_smile", "t": 0.0, "M": 8, "n_strikes": 23, "mean": 0.12345678901234,
     "ok": True, "x": float("nan"), "errors": [0.0, 0.1, 1e-07], "Quality Flag": "ok"},
    {"kind": "greeks", "t": 0.5, "M": 8, "mean": 1e-05, "ok": False,
     "Relative Error": np.float64(0.3), "big": 1e20, "Batch Size": np.int64(3)},
    {"kind": "surface2d", "t": 0.5, "M": 1024, "mean": 2.0, "ok": np.bool_(True),
     "Relative Error": float("inf"), "Quality Flag": "off_oracle", "note": "a, b"},
]


@pytest.mark.parametrize("learned,oracle,kw", [
    (1.01, 1.0, {}), (1.05, 1.0, {}), (1.05, 1.0, {"rel_threshold": 0.1}),
    (1.0, 1.0, {"degenerate": True}), (float("nan"), 1.0, {}), (0.5, 0.0, {}),
])
def test_quality_row_matches_jax(learned, oracle, kw):
    ours, ref = quality_row(learned, oracle, **kw), jax_quality_row(learned, oracle, **kw)
    assert ours["Quality Flag"] == ref["Quality Flag"]
    np.testing.assert_equal(ours["Relative Error"], ref["Relative Error"])


@pytest.mark.parametrize("columns", [None, "results"])
def test_csv_equals_jax(tmp_path, columns):
    assert RESULT_COLUMNS == JAX_RESULT_COLUMNS
    cols = RESULT_COLUMNS if columns else None
    ours, ref = ResultsReport(columns=cols), JaxResultsReport(columns=cols)
    for row in ROWS:
        ours.add_row(**row)
        ref.add_row(**row)
    a, b = ours.to_csv(str(tmp_path / "ours" / "r.csv")), ref.to_csv(str(tmp_path / "r.csv"))
    assert open(a).read() == open(b).read()
    pd.testing.assert_frame_equal(pd.read_csv(a), pd.read_csv(b))
    pd.testing.assert_frame_equal(ours.to_dataframe(), ref.to_dataframe())


@pytest.fixture(scope="module")
def trainers():
    """A JAX trainer after 20 iterations and a port trainer holding its
    weights (BSB, D = 3, FC-Sine [4, 16, 16, 16, 1])."""
    kw = dict(M=8, N=4, layers=[4, 16, 16, 16, 1], seed=0)
    jtr = JaxTrainer(JaxBSB(D=3), **kw)
    jtr.train(20, 1e-3, log_every=10, verbose=False)
    tr = Trainer(BlackScholesBarenblatt(D=3), device="cpu", **kw)
    src = from_flax_params(jax.tree.map(np.asarray, jtr.params), "sine", device="cpu")
    with torch.no_grad():
        for p, q in zip(tr.params.parameters(), src.parameters()):
            p.copy_(q)
    return jtr, tr


def _close(actual, reference, tol=1e-4):
    actual, reference = np.asarray(actual, np.float64), np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.abs(actual - reference).max() <= tol * (np.abs(reference).max() + 1e-30)


def test_perturbation_errors_match_jax(trainers):
    jtr, tr = trainers
    t, W = jtr.fetch_minibatch(key=jax.random.PRNGKey(3))
    t, W = np.asarray(t), np.asarray(W)
    ref = JaxStabilityCheck(jtr, perturbation_range=[0.0, 0.1, 0.3]).run_perturbation_analysis(
        t, W)
    ours = StabilityCheck(tr, perturbation_range=[0.0, 0.1, 0.3]).run_perturbation_analysis(
        t, W)
    assert ours[0] == 0.0
    _close(ours, ref)
    # without given paths, one minibatch drawn from a generator seeded ``seed``
    errs = StabilityCheck(tr, perturbation_range=[0.0, 0.2]).run_perturbation_analysis()
    assert errs[0] == 0.0 and np.isfinite(errs).all()


def test_spectral_radii_match_jax(trainers):
    jtr, tr = trainers
    X = np.random.default_rng(1).uniform(-1.0, 1.0, (32, 3)).astype(np.float32)
    for t in (0.0, 0.6):
        _close(StabilityCheck(tr).spectral_radii(X, t), JaxStabilityCheck(jtr).spectral_radii(X, t))
    radii = StabilityCheck(tr, num_points=16).evaluate_stability()
    assert radii.shape == (16,) and np.isfinite(radii).all()
    assert StabilityCheck(tr).stable_percentage(radii) == float((radii < 1.0).mean() * 100.0)


def test_jacobian_surfaces_match_jax(trainers):
    jtr, tr = trainers
    t_grid, s_grid = np.linspace(0.0, 1.0, 12), np.linspace(0.5, 1.5, 12)
    for dim in (0, 2):
        _close(StabilityCheck(tr).jacobian_surface(t_grid, s_grid, dim),
               JaxStabilityCheck(jtr).jacobian_surface(t_grid, s_grid, dim))
    ours = StabilityCheck(tr).smoothed_jacobian_surface(t_grid, s_grid, upsample=40)
    ref = JaxStabilityCheck(jtr).smoothed_jacobian_surface(t_grid, s_grid, upsample=40)
    for a, b in zip(ours, ref):
        _close(a, b)
