"""The port's Heston surface executor against the JAX package's.

Grading parity: a JAX trainer built as ``HestonSurfaceExecutor.execute``
builds it is trained, and a port trainer holding its weights and EMA shadow
takes the port's place; with each executor's training replaced by its
trainer, both executors grade and write their CSVs. The model's IV smile
agrees within 5e-3 volpts (max) and 1e-3 (mean) at each grading time, the
greeks' and the 2-D surface's rel-L2s within 1e-4 (absolute), and the CSVs
have the same columns, rows, kinds and ``ok`` flags. The port's own
training path runs end to end at the JAX tests' tiny size, with the
discrete-oracle columns (the CLI's ``--surface`` is in test_torch_cli.py)."""

from __future__ import annotations

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import dnnpde_tpu.experiments.executors as jax_ex
import dnnpde_tpu_torch.experiments.executors as ex
from dnnpde_tpu.sim import lognormal_x0 as jax_lognormal_x0
from dnnpde_tpu_torch.params import from_flax_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with several test workers on one host, PyTorch's
    default of one thread per core makes these small CPU ops many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(M=64, N=10, width=32, depth=2, budget=40, smile_t_evals=(0.0, 0.5),
           t_evals=(0.5,), s_grid=(0.6, 1.5, 15), v_grid=(0.6, 1.8, 3), seed=0)


@pytest.fixture(scope="module")
def graded(tmp_path_factory):
    """Both executors' reports and smiles on one JAX-trained solution."""
    tmp = tmp_path_factory.mktemp("surface")
    jcfg, cfg = jax_ex.SurfaceConfig(**CFG), ex.SurfaceConfig(**CFG)
    jexe = jax_ex.HestonSurfaceExecutor(jcfg, str(tmp / "jax"))
    p = jexe.problem
    jtr = jax_ex.Trainer(p, M=jcfg.M, N=jcfg.N, layers=[3, 32, 32, 1], mode="FC",
                         activation="Sine", seed=0, ema_decay=jcfg.ema_decay,
                         x0_sampler=jax_lognormal_x0(p.x0, jcfg.x0_scale),
                         objective="local")
    jtr.train(40, 1e-3, log_every=40, verbose=False)
    jtr.train = lambda *a, **k: None

    trainer_cls = ex.Trainer

    def port_trainer(*args, **kwargs):
        tr = trainer_cls(*args, **kwargs)
        tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        with torch.no_grad():
            for a, b in zip(tr.params.parameters(),
                            from_flax_params(tree(jtr.params), "sine", device="cpu").parameters()):
                a.copy_(b)
        tr._set_ema(from_flax_params(tree(jtr.ema_params), "sine", device="cpu"))
        tr.train = lambda *a, **k: None
        return tr

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_ex, "Trainer", lambda *a, **k: jtr)
        m.setattr(ex, "Trainer", port_trainer)
        jexe.execute()
        exe = ex.HestonSurfaceExecutor(cfg, str(tmp / "ours"), device="cpu")
        exe.execute()
        ptr = port_trainer(exe.problem, M=8, N=4, layers=[3, 32, 32, 1], ema_decay=0.999,
                           device="cpu")
    strikes = np.asarray(cfg.strikes)
    smiles = {t: (exe._iv(exe._model_smile(ptr, strikes, t), strikes, t),
                  np.asarray(jexe._iv(jexe._model_smile(jtr, strikes, t), strikes, t)))
              for t in CFG["smile_t_evals"]}
    return (pd.read_csv(tmp / "ours" / "results_heston_surface.csv"),
            pd.read_csv(tmp / "jax" / "results_heston_surface.csv"), smiles)


@pytest.mark.parametrize("t", CFG["smile_t_evals"])
def test_smile_ivs_match_jax(graded, t):
    ours, ref = graded[2][t]
    err = np.abs(ours - ref) * 100.0  # volpts
    assert err.max() <= 5e-3 and err.mean() <= 1e-3


def test_rows_match_jax(graded):
    ours, ref, _ = graded
    assert list(ours.columns) == list(ref.columns)
    assert list(ours["kind"]) == list(ref["kind"]) == ["iv_smile", "iv_smile", "greeks",
                                                       "surface2d"]
    assert list(ours["ok"]) == list(ref["ok"])
    smile = ref["kind"] == "iv_smile"
    for col in ("mean_abs_iv_err_volpts", "max_abs_iv_err_volpts", "atm_iv_err_volpts"):
        np.testing.assert_allclose(ours.loc[smile, col], ref.loc[smile, col], rtol=0, atol=5e-3)
    for col in ("price_rel_l2", "delta_rel_l2", "gamma_rel_l2", "price2d_rel_l2",
                "vega_rel_l2"):
        rows = ref[col].notna()
        assert (ours[col].notna() == rows).all()
        np.testing.assert_allclose(ours.loc[rows, col], ref.loc[rows, col], rtol=0, atol=1e-4)


def test_executor_trains_end_to_end_with_the_discrete_oracle(tmp_path):
    """tests/test_executors.py's discrete-oracle test on the port: training
    runs, and discrete_oracle_paths > 0 adds the vs-discrete columns."""
    cfg = ex.SurfaceConfig(M=8, N=3, width=16, depth=2, budget=4, x0_scale=0.3,
                           x0_scale_v=0.6, strikes=(0.95, 1.05), t_evals=(0.5,),
                           s_grid=(0.8, 1.3, 11), discrete_oracle_paths=256)
    rep = ex.HestonSurfaceExecutor(cfg, str(tmp_path), device="cpu").execute()
    df = pd.read_csv(tmp_path / "results_heston_surface.csv")
    assert list(df["kind"]) == ["iv_smile", "greeks", "surface2d"]
    smile = df[df["kind"] == "iv_smile"].iloc[0]
    assert np.isfinite(smile["mean_abs_iv_err_vs_discrete_volpts"])
    assert len(rep.rows) == 3
