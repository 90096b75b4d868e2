"""Experiment drivers (L6): grid sweeps producing CSV and plot artifacts, the
counterpart of ``dnnpde_tpu/experiments/executors.py``.

- :class:`TrainingExecutor`: the basket-call grid over
  M × D × lr × iters × optimizer × mode × activation, against the
  Monte-Carlo price, with spectral radii.
- :class:`CorrExecutor`: the correlation-type sweep against the Monte-Carlo
  and analytical basket prices, with an error heatmap.
- :class:`TestCaseExecutor`: the BSB test case against its closed form,
  with the perturbation analysis and the smoothed Jacobian surface.
- :class:`HJBExecutor`: the HJB M × D sweep against the Monte-Carlo oracle.
- :class:`HestonExecutor`: the Heston batch-size sweep against the closed
  form, with a three-oracle cross-check and the clamp-pinned flag.
- :class:`HestonSurfaceExecutor` (:class:`SurfaceConfig`): the surface
  recipe (local objective, BS head, lognormal X0, EMA read), graded as an
  IV smile, price/Δ/Γ surfaces and a 2-D (S, v) surface with vega.
- :class:`SensitivityExecutor`: real samples trained as one two-phase
  ensemble program plus synthetic ones, scored by HSIC.

Every executor takes its config, an output directory and ``device`` (None:
the first CUDA card, raising without one; "cpu" runs on the CPU). Its
trainers and Monte-Carlo oracles run there; each oracle draws from a
``torch.Generator`` seeded with the config's seed where JAX passes
``PRNGKey(seed)``. The CSVs are the JAX package's (``evals/reports.py``);
without matplotlib the plots are ``.npz`` arrays (``evals/plots.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dnnpde_tpu_torch.evals import (
    RESULT_COLUMNS,
    PredictionGenerator,
    ResultsReport,
    SensitivityAnalyzer,
    StabilityCheck,
    TrainingPlot,
    compute_greeks,
    error_stats,
    heston_greeks,
    quality_row,
    sample_hyperparameters,
    simulate_performance,
)
from dnnpde_tpu_torch.numerics import (
    HestonParams,
    basket_analytical_approx,
    basket_call_mc,
    basket_price_paths_mc,
    discrete_bsde_surface,
    heston_call_price,
    heston_delta_surface,
    heston_gamma_surface,
    heston_mc_price,
    heston_mc_price_ii,
    heston_price_surface,
    hjb_exact_mc,
    implied_vol,
)
from dnnpde_tpu_torch.pde import (
    BasketCallOption,
    BSPDETestCase,
    HamiltonJacobiBellman,
    HestonPDE,
)
from dnnpde_tpu_torch.runtime import default_device
from dnnpde_tpu_torch.sim import lognormal_x0
from dnnpde_tpu_torch.solver import make_net_u
from dnnpde_tpu_torch.train import Trainer, default_layers


@dataclasses.dataclass
class SweepConfig:
    """Grid axes of the sweep executors. ``phases`` ([(iters, lr), ...])
    replaces the two-phase lr_pairs × iter_pairs protocol (the CSV then
    reports lr_pairs/iter_pairs as given); ``ema_decay`` reads learned
    prices from the EMA shadow; rows whose |learned/oracle − 1| passes
    ``quality_rel_threshold`` are flagged "off_oracle"."""

    Ms: Sequence[int] = (100,)
    Ds: Sequence[int] = (100,)
    N: int = 50
    lr_pairs: Sequence[tuple[float, float]] = ((1e-3, 1e-5),)
    iter_pairs: Sequence[tuple[int, int]] = ((2000, 500),)
    phases: Optional[Sequence[tuple[int, float]]] = None
    optimizers: Sequence[str] = ("Adam",)
    modes: Sequence[str] = ("Naisnet",)
    activations: Sequence[str] = ("Sine", "ReLU")
    hidden: Sequence[int] = (256, 256, 256, 256)
    seed: int = 42
    ema_decay: Optional[float] = None
    quality_rel_threshold: float = 0.02


def _train_two_phase(trainer, lr_pair, iter_pair, optimizer, phases=None):
    """The two-phase protocol (``TrainingPhases``), or the ``phases``
    anneal. Returns the first and last phase results; the last one's
    ``min_loss`` covers every phase."""
    if phases:
        results = [trainer.train(n, lr, optimizer, verbose=False) for n, lr in phases]
        results[-1].min_loss = min(r.min_loss for r in results)
        return results[0], results[-1]
    r1 = trainer.train(iter_pair[0], lr_pair[0], optimizer, verbose=False)
    r2 = trainer.train(iter_pair[1], lr_pair[1], optimizer, verbose=False)
    return r1, r2


def _pinned(y0s: np.ndarray) -> bool:
    """Y0 never moved over the run: the degenerate-trajectory flag."""
    return bool(y0s.size) and bool(np.all(y0s == y0s[0]))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


class TrainingExecutor:
    """Basket-call grid sweep → results.csv + plots."""

    def __init__(self, config: SweepConfig, save_path: str, problem_cls=BasketCallOption,
                 device=None):
        self.config = config
        self.save_path = save_path
        self.problem_cls = problem_cls
        self.device = default_device(device)
        self.report = ResultsReport(columns=RESULT_COLUMNS)
        self.plot = TrainingPlot(save_path)

    def execute(self) -> ResultsReport:
        c, dev = self.config, self.device
        for M, D, lr, iters, opt, mode, act in itertools.product(
            c.Ms, c.Ds, c.lr_pairs, c.iter_pairs, c.optimizers, c.modes, c.activations
        ):
            tic = time.time()
            problem = self.problem_cls(D=D)
            trainer = Trainer(problem, M=M, N=c.N, layers=[D + 1, *c.hidden, 1], mode=mode,
                              activation=act, seed=c.seed, ema_decay=c.ema_decay, device=dev)
            r1, r2 = _train_two_phase(trainer, lr, iters, opt, phases=c.phases)
            preds = PredictionGenerator(
                trainer, num_samples=4, use_ema=c.ema_decay is not None).generate_predictions()
            # the oracle's standard error stays beside its price
            exact_price, exact_se = basket_call_mc(
                torch.Generator(device=dev).manual_seed(c.seed), torch.ones(D, device=dev),
                problem.strike, problem.T, problem.r, problem.sigma_bar, num_paths=200_000)
            learned_price = float(preds.Y_pred[:, 0, 0].mean())
            stats = error_stats(preds.Y_pred[:, 0, 0], float(exact_price))
            radii = StabilityCheck(trainer, num_points=32).evaluate_stability()
            quality = quality_row(learned_price, float(exact_price),
                                  rel_threshold=c.quality_rel_threshold,
                                  degenerate=_pinned(np.asarray(trainer.y0_log)))
            # r2.graph holds both phases; the label carries every swept axis
            label = f"{opt}_D{D}_M{M}_lr{lr[0]:g}-{lr[1]:g}_it{iters[0]}-{iters[1]}"
            self.plot.plot_training_loss(r2.graph, mode, act, label)
            self.plot.plot_prediction(preds.t_test, preds.Y_pred, mode, act, label)
            self.report.add_row(**{
                "Batch Size": M, "Dimensions": D,
                "Initial LR": lr[0], "Fine Tuning LR": lr[1],
                "Initial Iters": iters[0], "Fine Tuning Iters": iters[1],
                "Optimizer": opt, "Mode": mode, "Activation": act,
                "Correlation": "no_correlation",
                "Mean Error": stats["mean_error"],
                "Std Error": stats["std_error"], "RMSE": stats["rmse"],
                "Min Loss": min(r1.min_loss, r2.min_loss),
                "Exact Price": float(exact_price),
                "Oracle SE": float(exact_se),
                "Learned Price": learned_price,
                **quality,
                "Mean Spectral Radius": float(np.mean(radii)),
                "Total Run Time": time.time() - tic,
            })
        self.report.to_csv(f"{self.save_path}/results.csv")
        return self.report


class CorrExecutor:
    """Correlated-basket sweep: the net against the Monte-Carlo price and
    the analytical approximation, with an error heatmap."""

    def __init__(
        self, config: SweepConfig, save_path: str,
        correlation_types: Sequence[str] = (
            "no_correlation", "random_correlation", "restricted_random_correlation"),
        device=None,
    ):
        self.config = config
        self.save_path = save_path
        self.correlation_types = correlation_types
        self.device = default_device(device)
        self.report = ResultsReport(columns=RESULT_COLUMNS)
        self.plot = TrainingPlot(save_path)

    def execute(self) -> ResultsReport:
        c, dev = self.config, self.device
        heat = np.zeros((len(self.correlation_types), len(c.Ds)))
        for (ci, corr_type), (di, D) in itertools.product(
            enumerate(self.correlation_types), enumerate(c.Ds)
        ):
            for M, lr, iters, opt, mode, act in itertools.product(
                c.Ms, c.lr_pairs, c.iter_pairs, c.optimizers, c.modes, c.activations
            ):
                tic = time.time()
                problem = BasketCallOption(D=D)
                trainer = Trainer(problem, M=M, N=c.N, layers=[D + 1, *c.hidden, 1],
                                  mode=mode, activation=act, seed=c.seed,
                                  correlation_type=corr_type, correlation_seed=c.seed,
                                  device=dev)
                r1, r2 = _train_two_phase(trainer, lr, iters, opt, phases=c.phases)
                preds = PredictionGenerator(trainer, num_samples=4).generate_predictions()
                S0 = torch.ones(D, device=dev)
                mc_price, mc_se = basket_call_mc(
                    torch.Generator(device=dev).manual_seed(c.seed), S0, problem.strike,
                    problem.T, problem.r, problem.sigma_bar, chol=trainer.chol,
                    num_paths=200_000)
                analytical = float(basket_analytical_approx(
                    S0, problem.strike, problem.T, problem.r, problem.sigma_bar, D))
                learned = float(preds.Y_pred[:, 0, 0].mean())
                stats = error_stats(preds.Y_pred[:, 0, 0], float(mc_price))
                heat[ci, di] = abs(learned - float(mc_price))
                quality = quality_row(learned, float(mc_price),
                                      rel_threshold=c.quality_rel_threshold,
                                      degenerate=_pinned(np.asarray(trainer.y0_log)))
                # the net's price paths against the Monte-Carlo ones
                _, mc_path = basket_price_paths_mc(
                    torch.Generator(device=dev).manual_seed(c.seed + 1), S0, problem.strike,
                    problem.T, problem.r, problem.sigma_bar, N=c.N, chol=trainer.chol)
                self.plot.plot_exact_vs_learned(
                    preds.t_test[:4], preds.Y_pred[:4],
                    np.broadcast_to(mc_path.cpu().numpy(), (4, c.N + 1)),
                    mode, act, f"{opt}_{corr_type}_D{D}")
                self.report.add_row(**{
                    "Batch Size": M, "Dimensions": D,
                    "Initial LR": lr[0], "Fine Tuning LR": lr[1],
                    "Initial Iters": iters[0], "Fine Tuning Iters": iters[1],
                    "Optimizer": opt, "Mode": mode, "Activation": act,
                    "Correlation": corr_type,
                    "Mean Error": stats["mean_error"],
                    "Std Error": stats["std_error"], "RMSE": stats["rmse"],
                    "Min Loss": min(r1.min_loss, r2.min_loss),
                    "Exact Price": float(mc_price), "Learned Price": learned,
                    **quality,
                    "Analytical Price": analytical,
                    "MC Standard Error": float(mc_se),
                    "Total Run Time": time.time() - tic,
                })
        self.plot.plot_error_heatmap(heat, list(self.correlation_types),
                                     [str(d) for d in c.Ds], name="CorrErrorHeatmap")
        self.report.to_csv(f"{self.save_path}/results_corr.csv")
        return self.report


class TestCaseExecutor:
    """BSB test case against its closed form u_exact, with the perturbation
    analysis and the smoothed Jacobian surface."""

    __test__ = False  # not a pytest class despite the name

    def __init__(self, config: SweepConfig, save_path: str, device=None):
        self.config = config
        self.save_path = save_path
        self.device = default_device(device)
        self.plot = TrainingPlot(save_path)
        self.report = ResultsReport()

    def execute(self) -> ResultsReport:
        c = self.config
        for M, D, lr, iters, opt, mode, act in itertools.product(
            c.Ms, c.Ds, c.lr_pairs, c.iter_pairs, c.optimizers, c.modes, c.activations
        ):
            tic = time.time()
            problem = BSPDETestCase(D=D)
            trainer = Trainer(problem, M=M, N=c.N, layers=[D + 1, *c.hidden, 1], mode=mode,
                              activation=act, seed=c.seed, device=self.device)
            r1, r2 = _train_two_phase(trainer, lr, iters, opt, phases=c.phases)
            preds = PredictionGenerator(trainer, num_samples=4).generate_predictions()
            # the corrected (3r + σ²) closed form (BSPDETestCase's docstring)
            Y_exact = problem.exact_solution(torch.from_numpy(preds.t_test),
                                             torch.from_numpy(preds.X_pred)).numpy()
            stats = error_stats(preds.Y_pred, Y_exact)
            stab = StabilityCheck(trainer, perturbation_range=[0.0, 0.1, 0.3])
            rel_errors = stab.run_perturbation_analysis()
            self.plot.plot_exact_vs_learned(preds.t_test, preds.Y_pred, Y_exact[:, :, 0],
                                            mode, act, opt)
            t_grid = np.linspace(0.0, problem.T, 12)
            s_grid = np.linspace(0.5, 1.5, 12)
            t_up, s_up, Z_up = stab.smoothed_jacobian_surface(t_grid, s_grid)
            self.plot.plot_jacobian_surface(t_up, s_up, Z_up, name=f"Jacobian_{mode}_{act}_{opt}")
            learned_y0 = float(preds.Y_pred[:, 0, 0].mean())
            self.report.add_row(
                M=M, D=D, mode=mode, activation=act, optimizer=opt,
                **stats,
                perturbation_errors=rel_errors,
                exact_y0=float(Y_exact[0, 0, 0]),
                learned_y0=learned_y0,
                **quality_row(learned_y0, float(Y_exact[0, 0, 0]),
                              rel_threshold=c.quality_rel_threshold),
                run_time=time.time() - tic,
            )
        self.report.to_csv(f"{self.save_path}/results_testcase.csv")
        return self.report


class HJBExecutor:
    """HJB sweep against the Monte-Carlo oracle."""

    def __init__(self, config: SweepConfig, save_path: str, device=None):
        self.config = config
        self.save_path = save_path
        self.device = default_device(device)
        self.report = ResultsReport()
        self.plot = TrainingPlot(save_path)

    def execute(self) -> ResultsReport:
        c, dev = self.config, self.device
        for M, D, lr, iters, opt, mode, act in itertools.product(
            c.Ms, c.Ds, c.lr_pairs, c.iter_pairs, c.optimizers, c.modes, c.activations
        ):
            tic = time.time()
            problem = HamiltonJacobiBellman(D=D)
            trainer = Trainer(problem, M=M, N=c.N, layers=[D + 1, *c.hidden, 1], mode=mode,
                              activation=act, seed=c.seed, device=dev)
            r1, r2 = _train_two_phase(trainer, lr, iters, opt, phases=c.phases)
            u_exact = float(hjb_exact_mc(torch.Generator(device=dev).manual_seed(c.seed), 0.0,
                                         np.zeros(D), T=problem.T))
            learned = trainer.y0_log[-1]
            self.report.add_row(
                M=M, D=D, mode=mode, activation=act, optimizer=opt,
                exact_u0=u_exact, learned_u0=learned,
                relative_error=abs(learned - u_exact) / abs(u_exact),
                **quality_row(learned, u_exact, rel_threshold=c.quality_rel_threshold),
                min_loss=min(r1.min_loss, r2.min_loss),
                run_time=time.time() - tic,
            )
            rel_curve = np.abs(np.asarray(trainer.y0_log) - u_exact) / abs(u_exact)
            self.plot.plot_convergence({"relative error": rel_curve},
                                       name=f"HJBRelError_D{D}_M{M}")
        self.report.to_csv(f"{self.save_path}/results_hjb.csv")
        return self.report


class HestonExecutor:
    """Heston batch-size sweep: |Y0 − closed form| per M."""

    def __init__(
        self,
        Ms: Sequence[int] = (2, 10, 50, 128, 500),
        N: int = 50,
        n_iter: tuple[int, int] = (2000, 500),
        lrs: tuple[float, float] = (1e-3, 1e-5),
        mode: str = "FC",
        activation: str = "Sine",
        save_path: str = ".",
        seed: int = 42,
        heston: Optional[HestonPDE] = None,
        device=None,
    ):
        self.Ms = Ms
        self.N = N
        self.n_iter = n_iter
        self.lrs = lrs
        self.mode = mode
        self.activation = activation
        self.save_path = save_path
        self.seed = seed
        self.device = default_device(device)
        self.problem = heston or HestonPDE()
        self.report = ResultsReport()
        self.plot = TrainingPlot(save_path)

    def oracle_cross_check(self, num_paths: int = 100_000,
                           num_steps: int = 500) -> dict[str, float]:
        """Y0 = u(0, S0, v0) by three independent oracles: the closed form,
        the reflection-Milstein Monte Carlo (scheme I) and the truncation
        Monte Carlo (scheme II), the two drawing in turn from one generator
        seeded ``seed``."""
        p = self.problem
        hp = HestonParams(K=p.strike, r=p.r, T=p.T, kappa=p.kappa, theta=p.theta,
                          sigma=p.sigma_v, rho=p.rho, v0=p.v0)
        closed = float(heston_call_price(p.S0, p.v0, hp, device=self.device))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        mc1, se1 = heston_mc_price(gen, p.S0, hp, num_paths, num_steps)
        mc2, se2 = heston_mc_price_ii(gen, p.S0, hp, num_paths, num_steps)
        return {
            "closed_form": closed,
            "mc_milstein_reflection": float(mc1), "mc_i_se": float(se1),
            "mc_euler_truncation_ii": float(mc2), "mc_ii_se": float(se2),
        }

    def execute(self) -> ResultsReport:
        p = self.problem
        oracles = self.oracle_cross_check()
        exact = oracles["closed_form"]
        oracle_report = ResultsReport()
        oracle_report.add_row(**oracles)
        oracle_report.to_csv(f"{self.save_path}/heston_oracle_cross_check.csv")
        for M in self.Ms:
            tic = time.time()
            trainer = Trainer(p, M=M, N=self.N, layers=default_layers(p.dim), mode=self.mode,
                              activation=self.activation, seed=self.seed, device=self.device)
            r1, r2 = _train_two_phase(trainer, self.lrs, self.n_iter, "Adam")
            y0s = np.asarray(trainer.y0_log)
            l2_errors = np.abs(y0s - exact)
            self.plot.plot_y0_evolution(trainer.iteration, y0s, exact_y0=exact,
                                        name=f"HestonY0_M{M}")
            # a run whose Y0 never moved, or ended pinned at the output clamp
            # far from the oracle (the dead-net collapse at tiny M), is
            # flagged degenerate
            clamp = p.clamp_u if p.clamp_u is not None else np.nan
            at_clamp = bool(y0s.size) and float(y0s[-1]) == clamp
            degenerate = _pinned(y0s) or (at_clamp and float(l2_errors[-1]) > 0.1 * abs(exact))
            self.report.add_row(
                M=M, exact_y0=exact, learned_y0=float(y0s[-1]),
                final_l2_error=float(l2_errors[-1]),
                min_loss=min(r1.min_loss, r2.min_loss),
                run_time=time.time() - tic,
                degenerate=degenerate,
                **quality_row(float(y0s[-1]), exact, degenerate=degenerate),
            )
            self._plot_learned_surfaces(trainer, M)
        self.report.to_csv(f"{self.save_path}/results_heston.csv")
        return self.report

    def _plot_learned_surfaces(self, trainer, M: int) -> None:
        """The learned price/Δ/Γ surfaces over (S, v) at t = 0."""
        S_vals = np.linspace(0.5, 1.5, 12)
        v_vals = np.linspace(0.05, 0.5, 8)
        Sg, Vg = np.meshgrid(S_vals, v_vals, indexing="ij")
        X = np.stack([Sg.ravel(), Vg.ravel()], axis=-1)
        u, delta, gamma_diag = compute_greeks(trainer, np.zeros((X.shape[0], 1)), X)
        shape = (len(S_vals), len(v_vals))
        self.plot.plot_heston_surfaces(S_vals, v_vals, u[:, 0].reshape(shape),
                                       delta[:, 0].reshape(shape),
                                       gamma_diag[:, 0].reshape(shape), name=f"HestonLearned_M{M}")


@dataclasses.dataclass
class SurfaceConfig:
    """Config of :class:`HestonSurfaceExecutor`; the defaults are the JAX
    package's surface recipe.

    budget: iterations in three phases at 1e-3, 1e-4, 1e-5 of
      ``budget // 2``, ``budget // 4`` and ``budget - 2 * (budget // 4)``
      (as the reference splits it, 25000 in all at the default 20000).
    x0_scale / x0_scale_v: the lognormal X0 jitter (v's own scale when set).
    objective / output_mode / ema_decay: the local objective, the HestonPDE
      head ("bs" or "plain"), the EMA read.
    strikes, smile_t_evals: the IV smile's strikes and grading times (t > 0
      grades the term structure at maturity T − t).
    t_evals, s_grid, v_grid: the greeks' and the 2-D surface's grading
      times and grids (v in multiples of v0).
    discrete_oracle_paths: > 0 also grades the t = 0 smile against the
      discrete-N BSDE oracle with that many paths per strike.
    iv_gate_volpts, vega_gate_rel_l2: the smile's and the 2-D rows' gates.
    z_match_weight, z_match_mask: the Z-matching term (0 = off).
    """

    M: int = 1024
    N: int = 50
    width: int = 512
    depth: int = 4
    budget: int = 20000
    x0_scale: float = 0.3
    x0_scale_v: Optional[float] = None
    objective: str = "local"
    output_mode: str = "bs"
    ema_decay: float = 0.999
    strikes: Sequence[float] = tuple(np.linspace(0.75, 1.3, 23))
    smile_t_evals: Sequence[float] = (0.0,)
    t_evals: Sequence[float] = (0.0, 0.5)
    s_grid: tuple[float, float, int] = (0.6, 1.5, 91)
    v_grid: tuple[float, float, int] = (0.6, 1.8, 7)
    seed: int = 0
    discrete_oracle_paths: int = 0
    iv_gate_volpts: float = 1.0
    vega_gate_rel_l2: float = 0.05
    z_match_weight: float = 0.0
    z_match_mask: tuple = (0.0, 1.0)


class HestonSurfaceExecutor:
    """Surface-solver driver: train u(0, ·) over a region of initial states
    and grade it as a surface: the IV smile against the Heston closed form
    (and optionally the discrete-N oracle) at each of ``smile_t_evals``,
    price/Δ/Γ rel-L2 on the S grid at v0 per grading time, and the 2-D
    (S, v) price surface with the variance-vega ∂u/∂v.

    Artifacts: ``results_heston_surface.csv`` (smile, greeks and surface2d
    rows with their ``ok`` flags), ``HestonSurface_iv_smile`` and the learned
    surfaces' plot under ``save_path``."""

    def __init__(self, config: Optional[SurfaceConfig] = None, save_path: str = ".",
                 heston: Optional[HestonPDE] = None, device=None):
        self.cfg = config or SurfaceConfig()
        self.save_path = save_path
        self.device = default_device(device)
        if heston is not None:
            self.problem = heston
        elif self.cfg.output_mode == "plain":
            self.problem = HestonPDE(clamp_output=False)
        else:
            self.problem = HestonPDE(clamp_output=True, clamp_smoothing=self.cfg.output_mode)
        self.report = ResultsReport()
        self.plot = TrainingPlot(save_path)

    # -- oracles ----------------------------------------------------------
    def _params_at(self, K: float, t: float) -> HestonParams:
        p = self.problem
        return HestonParams(K=float(K), r=p.r, T=p.T - t, kappa=p.kappa, theta=p.theta,
                            sigma=p.sigma_v, rho=p.rho, v0=p.v0)

    def _closed_form_smile(self, strikes: np.ndarray, t: float = 0.0) -> np.ndarray:
        p = self.problem
        return np.asarray([float(heston_call_price(1.0, p.v0, self._params_at(k, t),
                                                   device=self.device)) for k in strikes])

    def _discrete_smile(self, strikes: np.ndarray) -> np.ndarray:
        p, cfg = self.problem, self.cfg
        S_eval = (1.0 / strikes).astype(np.float32)
        x0s = np.stack([S_eval, np.full_like(S_eval, p.v0)], axis=-1)
        vals = discrete_bsde_surface(
            p, N=cfg.N, x0s=x0s, n_paths=cfg.discrete_oracle_paths,
            batch=min(cfg.discrete_oracle_paths, 1_048_576), seed=cfg.seed + 11,
            device=self.device)
        return strikes * np.asarray([v.value for v in vals])

    def _model_smile(self, trainer, strikes: np.ndarray, t: float = 0.0) -> np.ndarray:
        """price(t, S=1, K) = K · u(t, 1/K, v0) by payoff homogeneity, read
        from the EMA shadow: one strike-1 net prices the whole (t, K)
        surface."""
        p, dev = self.problem, self.device
        S_eval = torch.as_tensor((1.0 / strikes).astype(np.float32), device=dev)
        X = torch.stack([S_eval, torch.full_like(S_eval, p.v0)], dim=-1)
        with torch.no_grad():
            u, _ = make_net_u(trainer.ema_params, transform=p.transform_u)(
                torch.full((len(strikes), 1), float(t), device=dev), X)
        return strikes * u[:, 0].cpu().numpy()

    def _iv(self, prices: np.ndarray, strikes: np.ndarray, t: float = 0.0) -> np.ndarray:
        p = self.problem
        return implied_vol(prices, 1.0, strikes, p.T - t, p.r, device=self.device).cpu().numpy()

    # -- driver ------------------------------------------------------------
    def execute(self) -> ResultsReport:
        cfg, p = self.cfg, self.problem
        layers = [p.dim + 1] + [cfg.width] * cfg.depth + [1]
        scale = cfg.x0_scale if cfg.x0_scale_v is None else [cfg.x0_scale, cfg.x0_scale_v]
        trainer = Trainer(
            p, M=cfg.M, N=cfg.N, layers=layers, mode="FC", activation="Sine", seed=cfg.seed,
            ema_decay=cfg.ema_decay, x0_sampler=lognormal_x0(p.x0, scale),
            objective=cfg.objective, z_match_weight=cfg.z_match_weight,
            z_match_mask=cfg.z_match_mask, device=self.device,
        )
        tic = time.time()
        half, quarter = cfg.budget // 2, cfg.budget - 2 * (cfg.budget // 4)
        for iters, lr in ((half, 1e-3), (cfg.budget // 4, 1e-4), (quarter, 1e-5)):
            if iters > 0:
                trainer.train(iters, lr, "Adam", verbose=False)
        train_wall = time.time() - tic

        strikes = np.asarray(cfg.strikes, np.float64)
        atm = int(np.argmin(np.abs(strikes - 1.0)))
        for t in tuple(cfg.smile_t_evals) or (0.0,):
            cf_iv = self._iv(self._closed_form_smile(strikes, t), strikes, t)
            model_iv = self._iv(self._model_smile(trainer, strikes, t), strikes, t)
            err = (model_iv - cf_iv) * 100.0  # vol points
            row = dict(
                kind="iv_smile", t=float(t), M=cfg.M, N=cfg.N,
                width=cfg.width, budget=cfg.budget, objective=cfg.objective,
                output_mode=cfg.output_mode, x0_scale=cfg.x0_scale,
                seed=cfg.seed, n_strikes=len(strikes),
                mean_abs_iv_err_volpts=float(np.mean(np.abs(err))),
                max_abs_iv_err_volpts=float(np.max(np.abs(err))),
                atm_iv_err_volpts=float(err[atm]),
                ok=bool(np.mean(np.abs(err)) <= cfg.iv_gate_volpts),
                run_time=train_wall,
            )
            discrete_iv = None
            if cfg.discrete_oracle_paths > 0 and t == 0.0:
                # the discrete oracle spans the whole [0, T] N-step scheme, so
                # it grades the served t = 0 smile only
                discrete_iv = self._iv(self._discrete_smile(strikes), strikes)
                err_d = (model_iv - discrete_iv) * 100.0
                row["mean_abs_iv_err_vs_discrete_volpts"] = float(np.mean(np.abs(err_d)))
                row["atm_iv_err_vs_discrete_volpts"] = float(err_d[atm])
            self.report.add_row(**row)
            if t == 0.0:
                self.plot.plot_iv_smile(strikes, model_iv, cf_iv, discrete_iv=discrete_iv,
                                        name="HestonSurface")

        self._grade_greeks(trainer)
        self._grade_surface2d(trainer)
        self.report.to_csv(f"{self.save_path}/results_heston_surface.csv")
        return self.report

    def _grade_greeks(self, trainer) -> None:
        """Price/Δ/Γ rel-L2 against the closed form's finite-difference
        surfaces on the S grid at v0, per grading time. The Δ oracle lives
        at forward-difference midpoints, so the model Δ is averaged onto
        them; the stencil's zero boundary rows are left out."""
        cfg, p = self.cfg, self.problem
        lo, hi, n = cfg.s_grid
        S = np.linspace(lo, hi, int(n))
        V = np.asarray([p.v0])
        sl = slice(1, -1)
        for t_eval in cfg.t_evals:
            hp_t = self._params_at(p.strike, t_eval)
            price_o = heston_price_surface(S, V, hp_t, device=self.device).cpu().numpy()[:, 0]
            delta_o = heston_delta_surface(S, V, hp_t, device=self.device).cpu().numpy()[:, 0]
            gamma_o = heston_gamma_surface(S, V, hp_t, device=self.device).cpu().numpy()[:, 0]
            u, delta, gamma = heston_greeks(trainer, S, np.full_like(S, p.v0), t_eval,
                                            use_ema=True)
            delta_mid = 0.5 * (delta[:-1] + delta[1:])
            self.report.add_row(
                kind="greeks", t=float(t_eval),
                M=cfg.M, N=cfg.N, width=cfg.width, budget=cfg.budget,
                objective=cfg.objective, output_mode=cfg.output_mode,
                x0_scale=cfg.x0_scale, seed=cfg.seed,
                price_rel_l2=_rel_l2(u[sl], price_o[sl]),
                delta_rel_l2=_rel_l2(delta_mid[:-1], delta_o[:-2]),
                gamma_rel_l2=_rel_l2(gamma[sl], gamma_o[sl]),
                ok=bool(_rel_l2(u[sl], price_o[sl]) < 0.02),
            )
            if t_eval == 0.0:
                self._plot_surfaces(trainer)

    def _grade_surface2d(self, trainer) -> None:
        """Price rel-L2 over the (s_grid × v_grid·v0) mesh against the closed
        form, and the variance-vega ∂u/∂v on the v = v0 slice (autograd
        through ``transform_u``) against the closed form's central
        difference, per grading time."""
        cfg, p = self.cfg, self.problem
        lo, hi, n = cfg.s_grid
        S = np.linspace(lo, hi, int(n))
        vlo, vhi, vn = cfg.v_grid
        V = np.linspace(vlo, vhi, int(vn)) * p.v0
        iv0 = int(np.argmin(np.abs(V - p.v0)))
        Sg, Vg = np.meshgrid(S, V, indexing="ij")
        X = np.stack([Sg.ravel(), Vg.ravel()], axis=-1)
        h = 0.05 * p.v0
        for t_eval in cfg.t_evals:
            hp_t = self._params_at(p.strike, t_eval)
            price_o = heston_price_surface(S, V, hp_t, device=self.device).cpu().numpy()
            tcol = np.full((X.shape[0], 1), t_eval, np.float32)
            u, grad, _ = compute_greeks(trainer, tcol, X, use_ema=True)
            price2d = _rel_l2(u[:, 0].reshape(len(S), len(V)), price_o)
            po = heston_price_surface(S, np.asarray([p.v0 - h, p.v0 + h]), hp_t,
                                      device=self.device).cpu().numpy()
            vega_o = (po[:, 1] - po[:, 0]) / (2.0 * h)
            vega_m = grad[:, 1].reshape(len(S), len(V))[:, iv0]
            self.report.add_row(
                kind="surface2d", t=float(t_eval), M=cfg.M, N=cfg.N,
                width=cfg.width, budget=cfg.budget, objective=cfg.objective,
                output_mode=cfg.output_mode, x0_scale=cfg.x0_scale,
                seed=cfg.seed,
                price2d_rel_l2=price2d,
                vega_rel_l2=_rel_l2(vega_m, vega_o),
                ok=bool(price2d < 0.02 and _rel_l2(vega_m, vega_o) < cfg.vega_gate_rel_l2),
            )

    def _plot_surfaces(self, trainer) -> None:
        S_vals = np.linspace(0.6, 1.5, 19)
        v_vals = np.linspace(0.05, 0.5, 8)
        Sg, Vg = np.meshgrid(S_vals, v_vals, indexing="ij")
        X = np.stack([Sg.ravel(), Vg.ravel()], axis=-1)
        u, delta, gamma_diag = compute_greeks(trainer, np.zeros((X.shape[0], 1)), X,
                                              use_ema=True)
        shape = (len(S_vals), len(v_vals))
        self.plot.plot_heston_surfaces(S_vals, v_vals, u[:, 0].reshape(shape),
                                       delta[:, 0].reshape(shape),
                                       gamma_diag[:, 0].reshape(shape),
                                       name="HestonSurfaceLearned")


class SensitivityExecutor:
    """Real training samples plus synthetic augmentation → HSIC scores. All
    real samples train as one two-phase ensemble program
    (``train.ensemble.train_sensitivity_ensemble``: per-member rates and
    phase lengths, one captured iteration on a card). ``evaluate_model`` is
    the sequential run of one sample, used for optimizers outside the
    ensemble's preconditioner set (LBFGS etc.)."""

    def __init__(
        self,
        problem,
        M: int = 32,
        N: int = 16,
        mode: str = "FC",
        activation: str = "Sine",
        optimizer: str = "Adam",
        save_path: str = ".",
        seed: int = 0,
        iter_scale: float = 1.0,
        device=None,
    ):
        self.problem = problem
        self.M = M
        self.N = N
        self.mode = mode
        self.activation = activation
        self.optimizer = optimizer
        self.save_path = save_path
        self.seed = seed
        self.iter_scale = iter_scale
        self.device = default_device(device)
        self.analyzer = SensitivityAnalyzer(device=self.device)

    def evaluate_model(self, hp: dict) -> float:
        """One real sample: two-phase training; returns the min loss."""
        trainer = Trainer(
            self.problem, M=self.M, N=self.N,
            layers=default_layers(self.problem.dim, width=64),
            mode=self.mode, activation=self.activation, seed=self.seed, device=self.device,
        )
        n1 = max(1, int(hp["initial_n_iter"] * self.iter_scale))
        n2 = max(1, int(hp["fine_tuning_n_iter"] * self.iter_scale))
        r1 = trainer.train(n1, hp["initial_lr"], self.optimizer, verbose=False)
        r2 = trainer.train(n2, hp["fine_tuning_lr"], self.optimizer, verbose=False)
        return min(r1.min_loss, r2.min_loss)

    def execute(self, num_real_samples: int = 32,
                num_simulated_samples: int = 968) -> dict[str, float]:
        rng = np.random.default_rng(self.seed)
        results = []
        real_hps = [sample_hyperparameters(rng) for _ in range(num_real_samples)]
        if real_hps:
            from dnnpde_tpu_torch.train import ensemble

            if self.optimizer.lower() in ensemble.PRECONDITIONERS:
                perfs = ensemble.train_sensitivity_ensemble(
                    self.problem, real_hps, M=self.M, N=self.N,
                    layers=default_layers(self.problem.dim, width=64),
                    mode=self.mode, activation=self.activation,
                    optimizer_type=self.optimizer, seed=self.seed,
                    iter_scale=self.iter_scale, device=self.device,
                )
                results += [{"hyperparams": hp, "performance": float(p)}
                            for hp, p in zip(real_hps, perfs)]
            else:  # sequential fallback (e.g. LBFGS)
                results += [{"hyperparams": hp, "performance": self.evaluate_model(hp)}
                            for hp in real_hps]
        for _ in range(num_simulated_samples):
            hp = sample_hyperparameters(rng)
            perf = float(simulate_performance({k: np.asarray(v) for k, v in hp.items()}, rng))
            results.append({"hyperparams": hp, "performance": perf})
        scores, _, _ = self.analyzer.analyze(results)
        return scores
