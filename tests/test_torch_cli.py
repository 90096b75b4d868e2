"""The port's CLI against the JAX package's, on the CPU: the parser's
actions (dest, default, choices, nargs), ``make_problem`` for all 13
problems, ``oracle_y0`` (the deterministic oracles within 1e-6 relative,
the Monte-Carlo ones within 4 combined SE), the end-to-end cases of
``tests/test_cli.py`` through ``main(..., device="cpu")`` (JAX's ``slow``
marks kept), ``--mode SDEnet`` and ``--surface``, the summary's key set, ``--dp 2`` on two
local gloo ranks, and the ``.npz`` plots written without matplotlib."""

from __future__ import annotations

import dataclasses
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dnnpde_tpu import cli as jcli
from dnnpde_tpu_torch import cli, numerics
from dnnpde_tpu_torch.cli import build_parser, main, make_problem, oracle_y0

TINY = ["--M", "8", "--N", "3", "--width", "8", "--depth", "2", "--iters", "4", "2",
        "--quiet", "--log-every", "4"]


def _actions(parser):
    return {a.dest: (a.default, a.choices, a.nargs, type(a).__name__)
            for a in parser._actions}


def test_parser_actions_are_jaxs():
    ours, ref = _actions(build_parser()), _actions(jcli.build_parser())
    assert ours == ref
    assert cli.PROBLEMS == jcli.PROBLEMS and len(cli.PROBLEMS) == 13
    args = build_parser().parse_args([])
    assert args.problem == "bsb" and args.M == 100 and args.N == 50
    assert args.iters == [2000, 500] and args.lrs == [1e-3, 1e-5]
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--problem", "navier-stokes"])


def _both(argv):
    return build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)


@pytest.mark.parametrize("extra", [[], ["--D", "5", "--T", "2.0", "--N", "18"],
                                   ["--heston-output", "plain", "--heston-diffusion",
                                    "reference"], ["--heston-output", "anchor"]],
                         ids=["defaults", "explicit", "heston-plain", "heston-anchor"])
@pytest.mark.parametrize("name", cli.PROBLEMS)
def test_make_problem_fields_are_jaxs(name, extra):
    args, jargs = _both(["--problem", name] + extra)
    ours, ref = make_problem(args), jcli.make_problem(jargs)
    assert type(ours).__name__ == type(ref).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.dim == ref.dim and args.N == jargs.N
    np.testing.assert_array_equal(ours.x0.numpy(), np.asarray(ref.x0))


def test_make_problem_resolutions():
    assert make_problem(build_parser().parse_args(["--problem", "american_put"])).dim == 1
    args = build_parser().parse_args(["--problem", "max_call"])
    p = make_problem(args)
    assert (p.dim, p.T, p.N_steps, args.N) == (2, 3.0, 45, 45)
    args = build_parser().parse_args(["--problem", "asian_call", "--N", "7"])
    assert make_problem(args).N_samples == 7


@pytest.mark.parametrize("name,extra", [
    ("bsb", ["--D", "10"]), ("testcase", ["--D", "5"]), ("call1d", ["--D", "1"]),
    ("heston", []), ("heston", ["--heston-output", "plain"]), ("american_put", ["--N", "10"]),
])
def test_deterministic_oracles_are_jaxs(name, extra):
    args, jargs = _both(["--problem", name] + extra)
    ours = oracle_y0(make_problem(args), args, device="cpu")
    ref = jcli.oracle_y0(jcli.make_problem(jargs), jargs)
    assert ours == pytest.approx(ref, rel=1e-6)


def _port_oracle(name, problem, args):
    """The port's Monte-Carlo oracle as ``oracle_y0`` calls it, once: its
    value and its standard error (``test_oracle_y0_makes_the_graded_call``
    holds that ``oracle_y0`` makes this very call)."""
    if name in ("call1d", "basket", "callnd"):
        K = problem.strike if name == "basket" else problem.K
        mc, se = numerics.basket_call_mc(
            torch.Generator(device="cpu").manual_seed(0), problem.x0, K, problem.T, problem.r,
            problem.sigma_bar, num_paths=200_000, payoff="mean" if name == "basket" else "sum",
            drift=2 * problem.r if name == "callnd" else None)
        return float(mc), float(se)
    if name in ("barrier_call", "asian_call", "lookback_call"):
        d = numerics.discrete_bsde_value(problem, N=args.N, n_paths=1_048_576, seed=0,
                                         device="cpu")
        return d.value, d.standard_error
    if name == "hjb":  # the SE by the delta method on −log mean e^{−g}, on numpy draws
        value = numerics.hjb_exact_mc(torch.Generator(device="cpu").manual_seed(0), 0.0,
                                      np.zeros(problem.dim), T=problem.T)
        rng = np.random.default_rng(0)
        y = np.sqrt(2.0 * problem.T) * rng.normal(size=(100_000, problem.dim))
        e = 1.0 / (0.5 + 0.5 * np.sum(y**2, axis=1))
        return float(value), float(e.std() / e.mean() / np.sqrt(e.size))
    basis = {"basis": "sorted"} if name == "max_call" else {}
    ls = numerics.lsmc_value(problem, N=args.N, n_regression=131_072, n_pricing=524_288,
                             seed=0, device="cpu", **basis)
    return ls.value, ls.standard_error


MC_CASES = [
    ("call1d", ["--D", "3"]), ("basket", ["--D", "5"]), ("callnd", ["--D", "5"]),
    ("hjb", ["--D", "5"]), ("barrier_call", ["--N", "4"]), ("asian_call", ["--N", "4"]),
    ("lookback_call", ["--N", "4"]), ("heston_american_put", ["--N", "4"]),
    ("max_call", ["--N", "9"]),
]


@pytest.mark.parametrize("name,extra", MC_CASES)
def test_monte_carlo_oracles_agree_with_jaxs_within_4_se(name, extra):
    args, jargs = _both(["--problem", name] + extra)
    ours, se = _port_oracle(name, make_problem(args), args)
    ref = jcli.oracle_y0(jcli.make_problem(jargs), jargs)
    assert 0.0 < se < 0.02 * abs(ref)
    assert abs(ours - ref) < 4 * np.sqrt(2.0) * se, (ours, ref, se)


def _same(v):
    """A call argument in a form that two calls can be compared by."""
    if isinstance(v, torch.Generator):
        return ("generator", v.initial_seed(), v.device.type)
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return ("array", np.asarray(v).tolist())
    if isinstance(v, (bool, int, float, str, type(None))):
        return v
    if isinstance(v, torch.device):
        return str(v)
    return ("object", id(v))


@pytest.mark.parametrize("name,extra", MC_CASES)
def test_oracle_y0_makes_the_graded_call(name, extra, monkeypatch):
    """``oracle_y0`` calls the numerics function ``_port_oracle`` grades,
    with the same arguments, and returns its value (the functions are
    stood in for by recorders, so nothing is simulated)."""
    fake = {
        "basket_call_mc": (torch.tensor(0.25), torch.tensor(0.01)),
        "discrete_bsde_value": SimpleNamespace(value=0.25, standard_error=0.01),
        "hjb_exact_mc": torch.tensor(0.25),
        "lsmc_value": SimpleNamespace(value=0.25, standard_error=0.01),
    }
    calls = []
    for fn, result in fake.items():
        def record(*a, _fn=fn, _result=result, **k):
            calls.append((_fn, [_same(v) for v in a], {key: _same(v) for key, v in k.items()}))
            return _result
        monkeypatch.setattr(numerics, fn, record)
    args = build_parser().parse_args(["--problem", name] + extra)
    problem = make_problem(args)
    value = oracle_y0(problem, args, device="cpu")
    routed, calls[:] = list(calls), []
    graded, _ = _port_oracle(name, problem, args)
    assert len(routed) == 1 and routed == calls
    assert value == graded == 0.25


def test_qmc_flag_gives_the_qmc_oracle():
    args, jargs = _both(["--problem", "barrier_call", "--N", "4", "--qmc"])
    ours = oracle_y0(make_problem(args), args, device="cpu")
    ref = jcli.oracle_y0(jcli.make_problem(jargs), jargs)
    assert ours == pytest.approx(ref, rel=1e-5)


def _run(tmp_path, argv):
    rc = main(argv + ["--out", str(tmp_path)], device="cpu")
    assert rc == 0
    return json.loads((tmp_path / "summary.json").read_text())


@pytest.mark.slow
def test_cli_end_to_end(tmp_path):
    summary = _run(tmp_path, ["--problem", "call1d", "--D", "1", *TINY,
                              "--checkpoint", str(tmp_path / "m.bin")])
    assert np.isfinite(summary["learned_y0"])
    assert summary["rel_error"] is not None
    assert (tmp_path / "m.bin").exists()
    assert any(f.suffix in (".png", ".npz") for f in tmp_path.iterdir())


def test_summary_keys_are_jaxs(tmp_path):
    argv = ["--problem", "call1d", "--D", "1", *TINY]
    (tmp_path / "jax").mkdir()
    assert jcli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    ref = json.loads((tmp_path / "jax" / "summary.json").read_text())
    ours = _run(tmp_path, argv)
    assert list(ours) == list(ref)
    assert ours["oracle_y0"] == pytest.approx(ref["oracle_y0"], rel=1e-6)
    assert ours["min_loss"] > 0 and ours["iters_per_sec"] > 0
    names = sorted(f.name for f in tmp_path.iterdir() if f.suffix == ".png")
    assert names == sorted(f.name for f in (tmp_path / "jax").iterdir() if f.suffix == ".png")


def test_cli_export_serving_artifact(tmp_path):
    art = tmp_path / "sol.pt"
    _run(tmp_path, ["--problem", "call1d", "--D", "1", *TINY, "--export", str(art)])
    from dnnpde_tpu_torch.serve import load_solution

    sol = load_solution(str(art), device="cpu")
    u, Z = sol.u_and_grad(0.0, np.ones((3, 1)))
    assert u.shape == (3, 1) and Z.shape == (3, 1)
    assert np.isfinite(u).all() and np.isfinite(Z).all()


def test_cli_export_keeps_the_barrier_transform(tmp_path):
    art = tmp_path / "sol.pt"
    summary = _run(tmp_path, ["--problem", "barrier_call", *TINY, "--export", str(art)])
    from dnnpde_tpu_torch.serve import load_solution

    sol = load_solution(str(art), device="cpu")
    assert sol.record["problem"] == "UpAndOutCall"
    u, _ = sol.u_and_grad(0.0, np.array([[1.0, 1.0], [1.0, 0.0]]))
    assert u[1, 0] == 0.0  # knocked out
    assert np.isfinite(summary["learned_y0"])


def test_cli_compute_dtype_flag(tmp_path):
    summary = _run(tmp_path, ["--problem", "call1d", "--D", "1", *TINY,
                              "--compute-dtype", "bfloat16"])
    assert np.isfinite(summary["learned_y0"])


def test_cli_antithetic_and_ema_flags(tmp_path):
    summary = _run(tmp_path, ["--problem", "call1d", "--D", "1", *TINY,
                              "--antithetic", "--ema-decay", "0.99"])
    assert np.isfinite(summary["learned_y0"])
    assert summary["ema_y0"] is not None and np.isfinite(summary["ema_y0"])


def test_cli_american_put(tmp_path):
    """The parser-default objective resolves to 'local'; the Bermudan-N
    tree is the oracle."""
    summary = _run(tmp_path, ["--problem", "american_put", "--D", "1", *TINY[:2],
                              "--N", "4", *TINY[4:]])
    assert np.isfinite(summary["learned_y0"])
    assert summary["oracle_y0"] == pytest.approx(0.0567, abs=0.002)


@pytest.mark.parametrize("name", ["barrier_call", "asian_call", "lookback_call"])
def test_cli_path_dependent_calls(tmp_path, name, monkeypatch):
    """Objective resolved to local (post_step problems); the oracle is the
    exact discrete chain."""
    seen = {}
    real = cli.make_problem

    def spy(args):
        p = real(args)
        seen["args"] = args
        return p

    monkeypatch.setattr(cli, "make_problem", spy)
    summary = _run(tmp_path, ["--problem", name, *TINY[:2], "--N", "4", *TINY[4:]])
    assert seen["args"].objective == "local"
    assert np.isfinite(summary["learned_y0"])
    assert 0.0 < summary["oracle_y0"] < 0.2
    if name == "barrier_call":
        assert summary["oracle_y0"] < 0.1  # knocked-out call ≪ vanilla


def test_cli_cv_price(tmp_path):
    summary = _run(tmp_path, ["--problem", "call1d", "--D", "1", *TINY, "--cv-price", "4096"])
    cv = summary["cv_price"]
    assert cv["n_paths"] == 4096 and cv["estimator"] == "cv_mc"
    assert np.isfinite(cv["value"]) and cv["standard_error"] > 0
    assert abs(cv["value"] - summary["oracle_y0"]) < 10 * (
        cv["standard_error"] + cv["plain_standard_error"])


def test_cli_cv_price_nonlinear_driver_reports_error(tmp_path):
    summary = _run(tmp_path, ["--problem", "bsb", "--D", "4", *TINY, "--cv-price", "1024"])
    assert "error" in summary["cv_price"]


def test_cli_heston_american_put(tmp_path):
    summary = _run(tmp_path, ["--problem", "heston_american_put", *TINY[:2], "--N", "4",
                              *TINY[4:]])
    assert np.isfinite(summary["learned_y0"])
    assert 0.12 < summary["oracle_y0"] < 0.22


def test_cli_cv_price_american_routes_to_lsmc(tmp_path):
    summary = _run(tmp_path, ["--problem", "american_put", *TINY[:2], "--N", "4", *TINY[4:],
                              "--cv-price", "8192"])
    cv = summary["cv_price"]
    assert cv["estimator"] == "cv_lsmc"
    assert abs(cv["value"] - summary["oracle_y0"]) / summary["oracle_y0"] < 0.05


def test_cli_polish(tmp_path, capsys):
    argv = ["--problem", "call1d", "--D", "1", "--M", "32", "--N", "4", "--width", "8",
            "--depth", "2", "--iters", "40", "20", "--log-every", "20", "--polish", "15",
            "--polish-m", "256"]
    summary = _run(tmp_path, argv)
    out = capsys.readouterr().out
    assert "polish: LBFGS 15 steps on a frozen antithetic batch of 256" in out
    assert np.isfinite(summary["learned_y0"])


def test_cli_sdenet_mode(tmp_path):
    """``--mode SDEnet`` trains a stochastic net (the noise from the
    trainer's generator), with EMA and an export that serves the fixed
    evaluation noise; the --surface runs are in test_torch_surface_executor.py."""
    from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
    from dnnpde_tpu_torch.serve import load_solution

    summary = _run(tmp_path, ["--problem", "bsb", "--D", "3", "--mode", "SDEnet", *TINY,
                              "--ema-decay", "0.9", "--export", str(tmp_path / "a.pt")])
    assert summary["mode"] == "SDEnet" and np.isfinite(summary["learned_y0"])
    sol = load_solution(str(tmp_path / "a.pt"), device="cpu")
    u, _ = sol.u_and_grad(np.zeros((1, 1)), BlackScholesBarenblatt(D=3).x0.numpy()[None])
    assert u[0, 0] == pytest.approx(summary["ema_y0"], rel=1e-6)


@pytest.mark.parametrize("budget", [[6, 2], [3, 1]])
def test_cli_surface(tmp_path, budget, monkeypatch, capsys):
    """``--problem heston --surface`` runs the executor with the flags
    mapped onto SurfaceConfig (the budget is --iters' sum) and returns 0
    exactly when the smile's ok holds (the executor itself:
    test_torch_surface_executor.py)."""
    import pandas as pd

    from dnnpde_tpu_torch.experiments import executors as surface

    seen = {}
    run = surface.HestonSurfaceExecutor.execute

    def spy(self):
        seen["cfg"] = self.cfg
        return run(self)

    monkeypatch.setattr(surface.HestonSurfaceExecutor, "execute", spy)
    argv = ["--problem", "heston", "--surface", "--M", "8", "--N", "4", "--width", "16",
            "--depth", "2", "--iters", *map(str, budget), "--out", str(tmp_path)]
    rc = main(argv, device="cpu")
    cfg = seen["cfg"]
    assert (cfg.M, cfg.N, cfg.width, cfg.depth, cfg.budget) == (8, 4, 16, 2, sum(budget))
    assert (cfg.objective, cfg.output_mode, cfg.x0_scale, cfg.seed) == ("local", "bs", 0.3, 0)
    df = pd.read_csv(tmp_path / "results_heston_surface.csv")
    smile_ok = bool(df.loc[df["kind"] == "iv_smile", "ok"].iloc[0])
    assert rc == (0 if smile_ok else 1)
    assert '"mean_abs_iv_err_volpts"' in capsys.readouterr().out
    with pytest.raises(SystemExit, match="requires --problem heston"):
        main(["--problem", "bsb", "--surface", "--out", str(tmp_path)], device="cpu")


@pytest.mark.parametrize("flag,item", [(["--dp", "2"], "parallel")])
def test_options_not_ported_yet_raise(tmp_path, flag, item, capfd):
    """``--dp`` was the last option not ported; it now starts two local
    ranks (gloo on the CPU) that train in lockstep, and rank 0 alone writes
    one summary, the plots and the checkpoint."""
    ck = tmp_path / "m.pt"
    rc = main(["--problem", "bsb", "--D", "4", *TINY[:-3], "--log-every", "2", *flag,
               "--checkpoint", str(ck), "--out", str(tmp_path)], device="cpu")
    assert rc == 0
    out = capfd.readouterr().out
    summaries = [ln for ln in out.splitlines() if ln.startswith('{"problem"')]
    assert len(summaries) == 1
    assert json.loads(summaries[0]) == json.loads((tmp_path / "summary.json").read_text())
    assert set(json.loads(summaries[0])) == set(_summary_keys())
    assert ck.exists() and any(f.suffix in (".png", ".npz") for f in tmp_path.iterdir())


def _summary_keys():
    return ["problem", "D", "M", "N", "mode", "activation", "optimizer", "learned_y0",
            "ema_y0", "oracle_y0", "rel_error", "min_loss", "wall_time_s", "iters_per_sec"]


def test_plots_are_npz_without_matplotlib(tmp_path, monkeypatch, capsys):
    for mod in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    _run(tmp_path, ["--problem", "call1d", "--D", "1", *TINY[:-3], "--log-every", "4"])
    assert "matplotlib is not installed" in capsys.readouterr().out
    files = sorted(f.name for f in tmp_path.iterdir())
    assert "TrainingLoss_FC_Sine_Adam.npz" in files and "Preds_FC_Sine_Adam.npz" in files
    assert not any(f.endswith(".png") for f in files)
    loss = np.load(tmp_path / "TrainingLoss_FC_Sine_Adam.npz")
    assert loss["iteration"].tolist() == [0, 4] and np.isfinite(loss["loss"]).all()


def test_main_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--problem", "call1d", "--D", "1", *TINY, "--out", str(tmp_path)])
    assert not (tmp_path / "summary.json").exists()
