"""Command-line interface of the PyTorch port, the counterpart of
``dnnpde_tpu/cli.py``:

  python3 -m dnnpde_tpu_torch --problem bsb --D 100 --M 100 --N 50 \\
      --mode FC --activation Sine --iters 2000 500 --lrs 1e-3 1e-5 \\
      --out results/

Trains on the first CUDA card (``main(argv, device="cpu")`` trains on the
CPU), grades the learned Y0 against the problem's oracle, and writes the
loss and prediction plots and ``summary.json`` to ``--out``. The flags,
their defaults and the summary's keys are the JAX CLI's. ``--problem heston
--surface`` runs the Heston surface executor instead (exit code 0 exactly
when the IV smile's ``ok`` holds). ``--dp n`` shards the paths over n ranks
(``parallel.make_mesh``): under torchrun (``WORLD_SIZE`` set) the process
joins that group, whose size must be n; otherwise the command starts n
local ranks of itself (``parallel.distributed.launch``) and returns the
worst exit code. Every rank trains; rank 0 alone writes the summary, the
plots, the checkpoint and the export. Without matplotlib the plots are
written as ``.npz`` arrays (``evals/plots.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

PROBLEMS = ("bsb", "call1d", "callnd", "basket", "testcase", "hjb",
            "heston", "american_put", "heston_american_put", "max_call",
            "barrier_call", "asian_call", "lookback_call")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dnnpde_tpu_torch",
        description="deep-BSDE PDE solver on an NVIDIA GPU (PyTorch port)",
    )
    p.add_argument("--problem", choices=PROBLEMS, default="bsb")
    p.add_argument("--D", type=int, default=100, help="state dimension")
    p.add_argument("--M", type=int, default=100, help="paths / batch size")
    p.add_argument("--N", type=int, default=50, help="time steps")
    p.add_argument("--T", type=float, default=1.0, help="terminal time")
    p.add_argument("--mode", default="FC",
                   help="FC | Naisnet | Resnet | Verlet | SDEnet")
    p.add_argument("--activation", default="Sine", help="Sine | ReLU | Tanh")
    p.add_argument("--width", type=int, default=256,
                   help="hidden width (default 256). When widening, scale "
                        "the lr down ~ 1/width (train.scaled_lr): width 1024 "
                        "at the default lr trains WORSE than 512; at "
                        "0.25x lr it wins (results_r4/dim1000_lr_width.log)")
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--optimizer", default="Adam")
    p.add_argument("--iters", type=int, nargs=2, default=[2000, 500],
                   metavar=("INITIAL", "FINE"))
    p.add_argument("--lrs", type=float, nargs=2, default=[1e-3, 1e-5],
                   metavar=("INITIAL", "FINE"))
    p.add_argument("--Mm", type=float, default=None,
                   help="time-step refinement base (enables the schedule)")
    p.add_argument("--correlation", default="no_correlation",
                   help="no_correlation | random_correlation | "
                        "restricted_random_correlation")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--heston-diffusion", default="cholesky",
                   choices=["cholesky", "reference"],
                   help="Heston 2x2 diffusion: 'cholesky' = true factor of "
                        "the Heston covariance (default); 'reference' = the "
                        "reference's matrix (heston_dnnpde.py:593-605 — not "
                        "a Heston factorization, bug #4; prices ~3.6%% low)")
    p.add_argument("--heston-output", default="bs",
                   choices=["plain", "hard", "softplus", "anchor", "bs"],
                   help="Heston output parametrization: 'bs' (default since "
                        "round 4) BS control-variate head — anchor parity "
                        "plus production-grade greeks | 'plain' the round-3 "
                        "default (+0.1..0.5%%, no collapse) | 'hard' "
                        "reference max(u,0) | 'softplus' | 'anchor' "
                        "payoff-anchored floor (see ARCHITECTURE.md 6b-6d)")
    p.add_argument("--objective", default="global",
                   choices=["global", "local", "local_ema"],
                   help="training objective: 'global' reference-style summed "
                        "residual | 'local' backward-induction per-step "
                        "residuals with detached targets (the round-4 "
                        "surface-mode winner: with --x0-scale and "
                        "--heston-output bs the Heston IV smile lands within "
                        "0.1 volpt of the closed form) | 'local_ema' frozen "
                        "EMA-shadow targets (needs --ema-decay)")
    p.add_argument("--polish", type=int, default=0, metavar="ITERS",
                   help="run a deterministic full-batch LBFGS polish phase "
                        "of ITERS steps after training (frozen antithetic "
                        "batch of --polish-m paths; Trainer.polish)")
    p.add_argument("--polish-m", type=int, default=8192, metavar="M",
                   help="frozen-batch size for --polish (default 8192)")
    p.add_argument("--compute-dtype", default=None, metavar="DTYPE",
                   help="net hidden-matmul dtype (e.g. bfloat16; params and "
                        "the output head stay f32) — measured +15%% "
                        "throughput at large batch with accuracy held")
    p.add_argument("--x0-scale", type=float, default=0.0, metavar="SCALE",
                   help="SURFACE-training mode: draw each iteration's "
                        "initial states X0 from a mean-preserving jitter of "
                        "scale SCALE around problem.x0 (lognormal for "
                        "positive-state problems, Gaussian for hjb) instead "
                        "of broadcasting one point — u(0, .) is then "
                        "learned on the sampled region, not just at x0 "
                        "(beyond-reference; see sim.x0_samplers)")
    p.add_argument("--x0-scale-v", type=float, default=None, metavar="SCALE",
                   help="surface mode: override the jitter scale of the "
                        "v-coordinate only (default: --x0-scale). Wider v "
                        "sampling trains the vega direction the 2-D grade "
                        "scores (heston --surface)")
    p.add_argument("--antithetic", action="store_true",
                   help="antithetic (dW, -dW) training minibatches — "
                        "variance-reduced loss/gradient estimator (even M)")
    p.add_argument("--ema-decay", type=float, default=None, metavar="DECAY",
                   help="Polyak/EMA parameter averaging (e.g. 0.999); the "
                        "summary reports the EMA-evaluated Y0 alongside the "
                        "raw one")
    p.add_argument("--dp", type=int, default=0,
                   help="shard paths over this many devices (0 = single)")
    p.add_argument("--checkpoint", default=None,
                   help="save final model/optimizer state here")
    p.add_argument("--export", default=None, metavar="PATH",
                   help="after training, export the solution as a serving "
                        "artifact (weights and problem as plain data; see "
                        "dnnpde_tpu_torch.serve)")
    p.add_argument("--cv-price", type=int, default=0, metavar="PATHS",
                   help="after training, MC-price with the net as a "
                        "control variate (evals.neural_cv_value): PATHS "
                        "simulated paths, reports the CV value, SE, and "
                        "the measured variance-reduction factor "
                        "(linear-driver problems only)")
    p.add_argument("--qmc", action="store_true",
                   help="use the randomized-QMC (Sobol + Brownian bridge) "
                        "discrete oracle where one applies "
                        "(barrier/Asian/lookback)")
    p.add_argument("--resume", default=None, help="load checkpoint before training")
    p.add_argument("--out", default="results", help="output directory")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--surface", action="store_true",
                   help="(--problem heston) run the packaged SURFACE-solver "
                        "protocol instead of the point solver: train u(0, ., "
                        "v0) over a region and grade the IV smile vs the "
                        "Heston closed form plus price/delta/gamma surface "
                        "rel-L2 (experiments.HestonSurfaceExecutor). Flags "
                        "left at their parser defaults resolve to the "
                        "measured round-4 recipe (M=1024, width=512, "
                        "objective=local, output=bs, x0-scale=0.3, 20k "
                        "iters -> 0.13-0.16 volpts mean |IV err|); pass a "
                        "flag explicitly to override it")
    return p


# Parser defaults that --surface re-resolves to the surface recipe when the
# user did not override them (SurfaceConfig holds the recipe).
_SURFACE_RESOLVED = {
    "M": 100, "N": 50, "width": 256, "depth": 4, "x0_scale": 0.0,
    "objective": "global", "heston_output": "bs", "iters": [2000, 500],
    "seed": 42,
}


def _surface_main(args, device) -> int:
    """--surface: map the CLI's flags onto SurfaceConfig (a flag at its
    parser default defers to the recipe; ``--iters A B`` sets the budget
    A + B) and run HestonSurfaceExecutor on ``device``. Returns 0 exactly
    when the IV smile's ``ok`` holds."""
    from dnnpde_tpu_torch.experiments import HestonSurfaceExecutor, SurfaceConfig

    if args.problem != "heston":
        raise SystemExit("--surface requires --problem heston")
    cfg_kwargs = {}
    for arg_name, cfg_name in (
        ("M", "M"), ("N", "N"), ("width", "width"), ("depth", "depth"),
        ("x0_scale", "x0_scale"), ("objective", "objective"),
        ("heston_output", "output_mode"), ("seed", "seed"),
    ):
        value = getattr(args, arg_name)
        if value != _SURFACE_RESOLVED[arg_name]:
            cfg_kwargs[cfg_name] = value
    if args.iters != _SURFACE_RESOLVED["iters"]:
        cfg_kwargs["budget"] = int(sum(args.iters))
    if args.ema_decay is not None:
        cfg_kwargs["ema_decay"] = args.ema_decay
    if args.x0_scale_v is not None:
        cfg_kwargs["x0_scale_v"] = args.x0_scale_v
    cfg = SurfaceConfig(**cfg_kwargs)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report = HestonSurfaceExecutor(cfg, str(out), device=device).execute()
    smile = next(r for r in report.rows if r["kind"] == "iv_smile")
    if not args.quiet:
        print(json.dumps({k: smile[k] for k in (
            "mean_abs_iv_err_volpts", "max_abs_iv_err_volpts",
            "atm_iv_err_volpts", "ok", "run_time")}))
    return 0 if smile["ok"] else 1


def make_problem(args):
    from dnnpde_tpu_torch import pde

    if args.problem == "bsb":
        return pde.BlackScholesBarenblatt(D=args.D, T=args.T)
    if args.problem == "call1d":
        return pde.CallOption1D(D=args.D, T=args.T)
    if args.problem == "callnd":
        return pde.CallOptionND(D=args.D, T=args.T)
    if args.problem == "basket":
        return pde.BasketCallOption(D=args.D, T=args.T)
    if args.problem == "testcase":
        return pde.BSPDETestCase(D=args.D, T=args.T)
    if args.problem == "hjb":
        return pde.HamiltonJacobiBellman(D=args.D, T=args.T)
    if args.problem == "barrier_call":
        return pde.UpAndOutCall(T=args.T)
    if args.problem == "asian_call":
        # the running average accumulates 1/N of each post-step sample, so
        # the contract's sampling count is tied to the solver grid
        return pde.AsianCallOption(T=args.T, N_samples=args.N)
    if args.problem == "lookback_call":
        return pde.LookbackCallOption(T=args.T)
    if args.problem == "american_put":
        # a put on ONE underlying: the parser-default D=100 resolves to 1; an
        # explicit multi-D (basket-sum put) drops the European-premium head
        D = 1 if args.D == 100 else args.D
        return pde.AmericanPutOption(D=D, T=args.T, bs_head=(D == 1))
    if args.problem == "max_call":
        # the Bermudan max-call benchmark (T = 3, nine dates): parser
        # defaults (D=100, T=1, N=50) resolve to D=2, T=3, N=45; explicit
        # flags are honored (N must be a multiple of the nine dates)
        D = 2 if args.D == 100 else args.D
        T = 3.0 if args.T == 1.0 else args.T
        N = 45 if args.N == 50 else args.N
        args.N = N
        return pde.BermudanMaxCall(D=D, T=T, N_steps=N)
    if args.problem == "heston_american_put":
        # needs objective="local" (main resolves it); bs-put head unless
        # --heston-output plain
        return pde.HestonAmericanPut(
            T=args.T, diffusion=args.heston_diffusion,
            clamp_output=args.heston_output != "plain")
    if args.problem == "heston":
        if args.heston_output == "plain":
            return pde.HestonPDE(T=args.T, diffusion=args.heston_diffusion,
                                 clamp_output=False)
        return pde.HestonPDE(
            T=args.T, diffusion=args.heston_diffusion,
            clamp_output=True, clamp_smoothing=args.heston_output,
        )
    raise ValueError(args.problem)


def _make_x0_sampler(args, problem):
    """--x0-scale > 0 → surface-training X0 jitter. hjb's state lives on
    all of R^D (x0 = 0), so it gets the additive sampler; every other
    problem in the zoo has strictly positive states (prices/variances)."""
    if not args.x0_scale:
        return None
    from dnnpde_tpu_torch.sim import gaussian_x0, lognormal_x0

    if args.problem == "hjb":
        return gaussian_x0(problem.x0, args.x0_scale)
    return lognormal_x0(problem.x0, args.x0_scale)


def oracle_y0(problem, args, device=None) -> float | None:
    """Best-available oracle for u(0, x0) per problem, computed on
    ``device`` (None: the first CUDA card). The Monte-Carlo oracles draw
    from generators seeded 0 where the JAX CLI takes ``PRNGKey(0)``."""
    import torch

    from dnnpde_tpu_torch import numerics
    from dnnpde_tpu_torch.runtime import default_device

    device = default_device(device)
    name = args.problem
    x0 = problem.x0
    if name in ("bsb", "testcase"):
        return float(problem.exact_solution(torch.zeros((1, 1)), x0[None, :])[0, 0])
    if name == "call1d" and problem.dim == 1:
        return float(numerics.black_scholes_call(
            1.0, problem.K, problem.T, problem.r, problem.sigma_bar, device=device))
    if name in ("call1d", "basket", "callnd"):
        # call1d, basket: risk-neutral drivers (phi = rY), drift r;
        # callnd: BSB-form driver + rX drift → e^{−rT}E[g] under drift 2r
        K = problem.strike if name == "basket" else problem.K
        mc, _ = numerics.basket_call_mc(
            torch.Generator(device=device).manual_seed(0), x0.to(device), K, problem.T,
            problem.r, problem.sigma_bar, num_paths=200_000,
            payoff="mean" if name == "basket" else "sum",
            drift=2 * problem.r if name == "callnd" else None,
        )
        return float(mc)
    if name in ("barrier_call", "asian_call", "lookback_call"):
        # matching discrete oracle: the same Euler + post_step chain.
        # --qmc swaps the pseudo-random draws for Owen-scrambled Sobol with
        # Brownian-bridge ordering (same unbiased value, far smaller SE)
        if getattr(args, "qmc", False):
            q = numerics.discrete_bsde_value_qmc(
                problem, N=args.N, n_paths=65_536, n_replicates=16, seed=0, device=device)
            return float(q.value)
        d = numerics.discrete_bsde_value(problem, N=args.N, n_paths=1_048_576, seed=0,
                                         device=device)
        return float(d.value)
    if name == "american_put":
        # matching Bermudan-N discrete oracle (exercise on the solver's grid)
        n_tree = 40 * args.N
        return float(numerics.crr_binomial(
            float(x0.sum()), problem.K, problem.T, problem.r, problem.sigma_bar,
            n_steps=n_tree, payoff="put", american=True, exercise_every=n_tree // args.N))
    if name == "heston_american_put":
        # no tree exists under Heston: Longstaff–Schwartz on the exact
        # solver chain (two-pass; low-biased fresh-path policy value)
        return float(numerics.lsmc_value(
            problem, N=args.N, n_regression=131_072, n_pricing=524_288, seed=0,
            device=device).value)
    if name == "max_call":
        # multi-asset: LSMC on the identical exact log-GBM chain with the
        # order-statistics basis
        return float(numerics.lsmc_value(
            problem, N=args.N, n_regression=131_072, n_pricing=524_288, seed=0,
            basis="sorted", device=device).value)
    if name == "hjb":
        return float(numerics.hjb_exact_mc(
            torch.Generator(device=device).manual_seed(0), 0.0, np.zeros(problem.dim),
            T=problem.T))
    if name == "heston":
        return float(numerics.heston_call_price(
            problem.S0, problem.v0,
            numerics.HestonParams(
                K=problem.strike, r=problem.r, T=problem.T,
                kappa=problem.kappa, theta=problem.theta,
                sigma=problem.sigma_v, rho=problem.rho, v0=problem.v0,
            ),
            device=device,
        ))
    return None


# a local rank of ``--dp``: ``python -c _RANK_MAIN DEVICE ARGV...``
_RANK_MAIN = (
    "import sys\n"
    "from dnnpde_tpu_torch.cli import main\n"
    "raise SystemExit(main(sys.argv[2:], device=sys.argv[1]))\n"
)


def main(argv=None, device=None) -> int:
    """Run the CLI on ``device`` (None: the first CUDA card, or each
    rank's own under ``--dp``; raises without one)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    import torch.distributed as dist

    from dnnpde_tpu_torch.runtime import default_device, maybe_enable_compilation_cache_from_env

    # DNNPDE_COMPILATION_CACHE=<dir> makes repeat CLI runs find their kernels
    # built (no nvcc) in that directory
    maybe_enable_compilation_cache_from_env()
    resolved = default_device(device)
    if args.surface:
        return _surface_main(args, resolved)
    if not args.dp:
        return _train_main(args, resolved, None)
    from dnnpde_tpu_torch import parallel
    from dnnpde_tpu_torch.parallel.distributed import launch

    if "WORLD_SIZE" not in os.environ:
        try:
            launch(args.dp, [sys.executable, "-c", _RANK_MAIN,
                             "cuda" if device is None else str(device), *argv],
                   capture=False, timeout_s=None)
        except RuntimeError as e:
            print(f"--dp {args.dp}: {e}", file=sys.stderr)
            return 1
        return 0
    parallel.init_distributed(device=device)
    try:
        if dist.get_world_size() != args.dp:
            raise ValueError(f"--dp {args.dp} in a group of {dist.get_world_size()} ranks")
        return _train_main(args, default_device(device),
                           parallel.make_mesh(args.dp, devices=device))
    finally:
        dist.destroy_process_group()


def _train_main(args, device, mesh) -> int:
    """Train, grade and write the outputs (on a mesh: every rank trains,
    rank 0 writes)."""
    import torch

    from dnnpde_tpu_torch.evals import PredictionGenerator, TrainingPlot
    from dnnpde_tpu_torch.train import Trainer

    main_rank = mesh is None or mesh.get_rank() == 0
    problem = make_problem(args)
    if args.objective == "global" and (
        getattr(problem, "early_exercise", False)
        or getattr(problem, "has_post_step", False)
    ):
        # the parser-default "global" resolves to "local" where it is
        # required (optimal stopping) or measured far better (barrier: the
        # value process jumps at knockout dates; local one-step targets
        # absorb the jump)
        args.objective = "local"

    layers = [problem.dim + 1] + [args.width] * args.depth + [1]
    trainer = Trainer(
        problem, M=args.M, N=args.N, layers=layers, mode=args.mode,
        activation=args.activation, Mm=args.Mm,
        correlation_type=args.correlation, seed=args.seed, mesh=mesh,
        net_kwargs=(
            {"compute_dtype": args.compute_dtype} if args.compute_dtype else None
        ),
        antithetic=args.antithetic,
        ema_decay=args.ema_decay,
        x0_sampler=_make_x0_sampler(args, problem),
        objective=args.objective,
        device=device,
    )
    if args.resume:
        trainer.load_model(args.resume)

    t0 = time.time()
    r1 = trainer.train(args.iters[0], args.lrs[0], args.optimizer,
                       log_every=args.log_every, verbose=not args.quiet)
    r2 = trainer.train(args.iters[1], args.lrs[1], args.optimizer,
                       log_every=args.log_every, verbose=not args.quiet)
    if args.polish:
        losses = trainer.polish(n_iter=args.polish, M=args.polish_m)
        if not args.quiet and main_rank:
            print(f"polish: LBFGS {args.polish} steps on a frozen "
                  f"antithetic batch of {args.polish_m}: loss "
                  f"{losses[0]:.3e} -> {losses[-1]:.3e}")
    wall = time.time() - t0
    if args.checkpoint:  # on a mesh a collective: every rank saves, rank 0 writes
        trainer.save_model(args.checkpoint)
    if not main_rank:
        return 0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    plot = TrainingPlot(str(out))
    if not args.quiet and not plot.have_matplotlib():
        print("plots: matplotlib is not installed; writing each plot's arrays as .npz")
    graph = np.stack((trainer.iteration, trainer.training_loss))
    plot.plot_training_loss(graph, args.mode, args.activation, args.optimizer)
    preds = PredictionGenerator(trainer, num_samples=4).generate_predictions()
    plot.plot_prediction(preds.t_test, preds.Y_pred, args.mode,
                         args.activation, args.optimizer)

    exact = oracle_y0(problem, args, device=device)
    # tail-average within the fine phase (Y0 snapshots wobble; same
    # methodology as the bench harness)
    fine_logs = max(1, args.iters[1] // args.log_every)
    learned = float(np.mean(trainer.y0_log[-min(3, fine_logs):]))
    ema_y0 = None
    if args.ema_decay is not None:
        from dnnpde_tpu_torch.solver import make_net_u

        with torch.no_grad():
            u, _ = make_net_u(trainer.ema_params, transform=problem.transform_u)(
                torch.zeros((1, 1), device=device), problem.x0.to(device)[None, :])
        ema_y0 = float(u[0, 0])
    summary = {
        "problem": args.problem, "D": problem.dim, "M": args.M, "N": args.N,
        "mode": args.mode, "activation": args.activation,
        "optimizer": args.optimizer,
        "learned_y0": learned,
        "ema_y0": ema_y0,
        "oracle_y0": exact,
        "rel_error": (abs(learned - exact) / max(abs(exact), 1e-12)
                      if exact is not None else None),
        "min_loss": min(r1.min_loss, r2.min_loss),
        "wall_time_s": wall,
        "iters_per_sec": sum(args.iters) / wall,
    }
    if args.cv_price:
        try:
            if getattr(problem, "early_exercise", False):
                # optimal stopping: the control variate applies to the
                # STOPPED process, CV-boosted LSMC
                from dnnpde_tpu_torch import numerics

                net = (trainer.ema_params if args.ema_decay is not None
                       else trainer.params)
                ls = numerics.lsmc_value(
                    problem, N=args.N,
                    n_regression=min(131_072, args.cv_price),
                    n_pricing=args.cv_price, seed=0, cv_net=net, device=device,
                )
                summary["cv_price"] = {
                    "value": ls.value, "standard_error": ls.standard_error,
                    "plain_value": ls.plain_value,
                    "variance_reduction": ls.cv_variance_reduction,
                    "c": ls.cv_c, "n_paths": ls.n_pricing,
                    "estimator": "cv_lsmc",
                }
            else:
                from dnnpde_tpu_torch.evals import neural_cv_from_trainer

                cv = neural_cv_from_trainer(
                    trainer, n_paths=args.cv_price,
                    use_ema=args.ema_decay is not None,
                )
                summary["cv_price"] = {
                    "value": cv.value, "standard_error": cv.standard_error,
                    "plain_value": cv.plain_value,
                    "plain_standard_error": cv.plain_standard_error,
                    "variance_reduction": cv.variance_reduction,
                    "c": cv.c, "n_paths": cv.n_paths,
                    "estimator": "cv_mc",
                }
        except ValueError as e:
            # nonlinear/Z-coupled driver (bsb, hjb): the telescoped MC target
            # does not exist — report why instead of discarding the training
            summary["cv_price"] = {"error": str(e)}
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    if args.export:
        from dnnpde_tpu_torch.serve import save_solution

        # with EMA on, export the parameters the summary headlines (ema_y0)
        save_solution(args.export, trainer, use_ema=args.ema_decay is not None)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
