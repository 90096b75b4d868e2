"""The port's sweep executors against the JAX package's, at
``tests/test_executors.py``'s tiny configs: each writes its CSV with the same
columns in the same order, the same number of rows, the same ``kind``,
``Quality Flag``, ``ok`` and ``degenerate`` sets and the same plot
artifacts, every numeric field finite where JAX's is. The Heston executor's
oracle cross-check (at 8192 Monte-Carlo paths of 50 steps, to keep the file
short) agrees with JAX's (the closed form within 1e-5 relative, each
Monte-Carlo price within 4 combined SE), and a clamp-pinned run is
flagged degenerate. ``SensitivityExecutor`` is held in
``tests/test_torch_sensitivity.py`` and ``tests/test_torch_ensemble.py``."""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import pytest
import torch

import dnnpde_tpu.experiments as jax_ex
import dnnpde_tpu_torch.experiments as ex
from dnnpde_tpu_torch.experiments import executors as ex_module


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with several test workers on one host, PyTorch's
    default of one thread per core makes these small CPU ops many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(
    Ms=(8,), Ds=(3,), N=4,
    lr_pairs=((1e-3, 1e-4),), iter_pairs=((6, 2),),
    optimizers=("Adam",), modes=("FC",), activations=("Sine",),
    hidden=(16, 16, 16, 16),
)
CASES = {
    "training": ("results.csv", lambda m, d, **kw: m.TrainingExecutor(m.SweepConfig(**TINY), d,
                                                                       **kw)),
    "corr": ("results_corr.csv", lambda m, d, **kw: m.CorrExecutor(
        m.SweepConfig(**TINY), d, correlation_types=("no_correlation", "random_correlation"),
        **kw)),
    "testcase": ("results_testcase.csv",
                 lambda m, d, **kw: m.TestCaseExecutor(m.SweepConfig(**TINY), d, **kw)),
    "hjb": ("results_hjb.csv", lambda m, d, **kw: m.HJBExecutor(
        m.SweepConfig(**{**TINY, "Ds": (5,)}), d, **kw)),
    "heston": ("results_heston.csv", lambda m, d, **kw: m.HestonExecutor(
        Ms=(4,), N=4, n_iter=(6, 2), save_path=d, mode="FC", **kw)),
}
FLAG_COLUMNS = ("kind", "Quality Flag", "ok", "degenerate", "Correlation")


def _stems(path) -> set[str]:
    return {os.path.splitext(f)[0] for f in os.listdir(path) if not f.endswith(".csv")}


def assert_same_structure(ours: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert list(ours.columns) == list(ref.columns)
    assert len(ours) == len(ref)
    for col in FLAG_COLUMNS:
        if col in ref.columns:
            assert set(ours[col]) == set(ref[col]), col
    for col in ref.columns:
        if pd.api.types.is_numeric_dtype(ref[col]) and not pd.api.types.is_bool_dtype(ref[col]):
            assert pd.api.types.is_numeric_dtype(ours[col]), col
            assert (np.isfinite(ours[col]) == np.isfinite(ref[col])).all(), col


def _small_cross_check(monkeypatch, *modules):
    """The Heston executors' Monte-Carlo cross-check at 8192 paths of 50
    steps in place of 100k of 500 (the CSV's structure does not depend on
    it; the 4-SE comparison holds at any size)."""
    for m in modules:
        full = m.HestonExecutor.oracle_cross_check
        monkeypatch.setattr(m.HestonExecutor, "oracle_cross_check",
                            lambda self, _full=full: _full(self, num_paths=8192, num_steps=50))


@pytest.mark.parametrize("name", list(CASES))
def test_executor_structure_matches_jax(name, tmp_path, monkeypatch):
    csv_name, make = CASES[name]
    _small_cross_check(monkeypatch, ex, jax_ex)
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "jax"
    make(ex, str(ours_dir), device="cpu").execute()
    make(jax_ex, str(ref_dir)).execute()
    ours, ref = pd.read_csv(ours_dir / csv_name), pd.read_csv(ref_dir / csv_name)
    assert_same_structure(ours, ref)
    assert _stems(ours_dir) == _stems(ref_dir)
    if name == "heston":
        ours = pd.read_csv(ours_dir / "heston_oracle_cross_check.csv")
        ref = pd.read_csv(ref_dir / "heston_oracle_cross_check.csv")
        assert list(ours.columns) == list(ref.columns)
        o, r = ours.iloc[0], ref.iloc[0]
        assert o["closed_form"] == pytest.approx(r["closed_form"], rel=1e-5)
        for col, se in (("mc_milstein_reflection", "mc_i_se"),
                        ("mc_euler_truncation_ii", "mc_ii_se")):
            assert abs(o[col] - r[col]) < 4 * np.hypot(o[se], r[se]), col


def test_heston_executor_flags_clamp_pinned_run(tmp_path, monkeypatch):
    """A run whose Y0 never leaves the output clamp is flagged degenerate
    (tests/test_executors.py's test of the same name)."""
    orig = ex_module._train_two_phase

    def pinned(trainer, lrs, n_iter, opt):
        r1, r2 = orig(trainer, lrs, n_iter, opt)
        trainer.y0_log = [0.0] * len(trainer.y0_log)
        return r1, r2

    monkeypatch.setattr(ex_module, "_train_two_phase", pinned)
    _small_cross_check(monkeypatch, ex)
    ex.HestonExecutor(Ms=(2,), N=4, n_iter=(4, 2), save_path=str(tmp_path),
                      device="cpu").execute()
    df = pd.read_csv(tmp_path / "results_heston.csv")
    assert bool(df.loc[0, "degenerate"]) is True
    assert df.loc[0, "Quality Flag"] == "degenerate"


def test_sweep_phases_fold_min_loss(tmp_path):
    """``SweepConfig.phases`` replaces the two-phase protocol; the row's
    min loss covers every phase."""
    cfg = ex.SweepConfig(**{**TINY, "phases": ((4, 1e-3), (3, 1e-4), (2, 1e-5))})
    rep = ex.HJBExecutor(cfg, str(tmp_path), device="cpu").execute()
    row = rep.rows[0]
    assert np.isfinite(row["min_loss"]) and row["Quality Flag"] in ("ok", "off_oracle")
