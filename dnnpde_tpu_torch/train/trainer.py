"""Trainer: the user-facing deep-BSDE training loop of the PyTorch port, the
counterpart of ``dnnpde_tpu/train/trainer.py``.

- The training loop runs in chunks of ``log_every`` iterations. One
  iteration (increments drawn on the device from the trainer's
  ``torch.Generator``, the loss, its gradients, clipping, the optimizer
  update, the NaN guard, the EMA update, the best-state update, and this
  iteration's loss and Y0 written into the chunk's device buffers at a
  device-side index) runs on tensors that keep their addresses from one
  iteration to the next (:class:`_Chunk`). On a CUDA device it is captured
  once into a CUDA graph and every later iteration is one replay of it: the
  counterpart of the JAX Trainer's jitted ``lax.scan`` chunk, which makes a
  chunk one dispatch. On the CPU the same iteration runs eagerly.
- Nothing is read back inside a chunk. A chunk's values are copied to the
  host once, and read one chunk later, while the next chunk runs.
- Everything the captured iteration binds (parameters, optimizer state, EMA
  shadow, the chunk's buffers) is updated in place: ``reset``,
  ``warm_start_from``, ``load_model``, a float learning-rate change and the
  collapse rollback copy into those tensors, and a change of optimizer or a
  schedule drops the captured iterations, as the JAX Trainer drops its
  compiled chunks.
- ``predict`` does not mutate the batch size.
- Optional NaN guard: skip the whole update, optimizer state and EMA
  included, when the loss is non-finite.

- The objective is "global", "local" or "local_ema" (the local objective
  with targets from the EMA shadow as it was before the iteration's
  update); ``x0_sampler`` draws a fresh X0 batch every iteration from the
  trainer's generator, after the increments.

- ``mode="SDEnet"`` trains a stochastic net: every net evaluation of the
  loss draws its noise from the trainer's generator (``_noise``), after the
  increments and X0, so a captured iteration draws inside the graph what
  the eager step would. ``predict``, ``evaluate_u``, greeks and serving
  evaluate it under the fixed noise of the evaluation paths and leave the
  generator alone.

- LBFGS (``optimizers.LBFGS``, optax's zoom-linesearch LBFGS) trains
  eagerly on every device: its linesearch re-evaluates the loss on the
  iteration's batch until a data-dependent condition holds, which a CUDA
  graph cannot capture. The choice is made by optimizer type, never by a
  failed capture. ``polish`` runs LBFGS on one frozen batch.
- Inside ``train.detect_anomalies`` every iteration runs eagerly too: its
  checks read values back to the host, which a capture forbids.

- ``mesh`` (``parallel.make_mesh`` / ``make_mesh_2d``) shards the paths
  over its "dp" dim: every rank draws the whole batch (increments, X0, a
  stochastic net's noise; path weights from the whole X0) from its
  generator, as the JAX Trainer draws globally, and keeps its M/dp rows.
  The local loss and gradients, Y0 from the rank at index 0 of "dp" (JAX's
  Y0 is the first path's) and, with ``track_best``, the rows' (X, Y) go
  into one flat buffer summed over "dp" by one all-reduce; clipping, the
  NaN guard, the collapse check and the best state then act on global
  values, and parameters, optimizer state and EMA stay bitwise equal on
  every rank. With a "tp" dim the wide layers hold their shard
  (``parallel.model_sharding``); checkpoints hold the full weights, written
  by rank 0. A chunk is captured into a CUDA graph only when every group is
  NCCL (its all-reduces then replay inside the graph); over gloo, whose
  collectives the host drives, it runs eagerly. The choice is made by the
  groups' backend, never by a failed capture.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import time
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dnnpde_tpu_torch import tracing
from dnnpde_tpu_torch.nets import build_network
from dnnpde_tpu_torch.parallel import model_sharding
from dnnpde_tpu_torch.parallel.distributed import all_reduce
from dnnpde_tpu_torch.parallel.mesh import DP_AXIS, axis_size
from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.runtime import default_device, full_f32_matmul
from dnnpde_tpu_torch.sim.brownian import brownian_increments, brownian_paths, time_grid
from dnnpde_tpu_torch.sim.correlation import cholesky_factor, generate_correlation_matrix
from dnnpde_tpu_torch.sim.x0_samplers import draw_x0
from dnnpde_tpu_torch.solver.bsde import (
    RolloutResult,
    SolverConfig,
    make_loss_fn,
    make_net_u,
    make_path_loss_fn,
)
from dnnpde_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from dnnpde_tpu_torch.train.graphed import CapturedChunk, assign_state, clone_state
from dnnpde_tpu_torch.train.optimizers import LBFGS, LearningRate, build_optimizer
from dnnpde_tpu_torch.train.schedules import TimeStepRefinement

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainResult:
    """Mirror of the reference ``train`` return: (graph, min_loss, min_loss_state)."""

    graph: np.ndarray  # (2, num_logs): iterations; mean losses
    min_loss: float
    min_loss_state: Optional[tuple[np.ndarray, np.ndarray]]  # best (X, Y) with track_best
    y0_history: np.ndarray  # Y0 at each log point
    wall_time: float


def default_layers(dim: int, width: int = 256, depth: int = 4) -> list[int]:
    """Reference default architecture [D+1, 256×4, 1]. When widening past
    256, scale the learning rate down with :func:`scaled_lr`."""
    return [dim + 1] + [width] * depth + [1]


def scaled_lr(width: int, base_lr: float = 1e-3, base_width: int = 256) -> float:
    """Learning rate for a net of hidden width ``width``: lr ∝ 1/width (the
    JAX package's measured rule)."""
    return base_lr * base_width / float(width)


class _NoiseTape:
    """A stochastic net's noise for one batch that is evaluated more than
    once (LBFGS's linesearch, ``polish``'s frozen batch): the i-th draw after
    ``rewind()`` is the i-th draw of the first pass, as the JAX Trainer
    passes one key to every evaluation of the batch."""

    def __init__(self, draw):
        self.draw, self.tape, self.pos = draw, [], 0

    def __call__(self, shape) -> Tensor:
        if self.pos == len(self.tape):
            self.tape.append(self.draw(shape))
        self.pos += 1
        return self.tape[self.pos - 1]

    def rewind(self) -> "_NoiseTape":
        self.pos = 0
        return self


class _Chunk(CapturedChunk):
    """The captured iterations of one (N, M, optimizer, features), the
    counterpart of the JAX Trainer's jitted chunk (``_make_chunk``): beside
    the log buffers, the time grid of its N and, with ``track_best``, the
    chunk's best loss and its (X, Y) paths."""

    def __init__(self, trainer: "Trainer", N: int, capacity: int):
        dev, dt, M = trainer.device, trainer.dtype, trainer.M
        self.N = N
        self.ts = time_grid(M, N, trainer.problem.T, dt, dev).transpose(0, 1)
        super().__init__(dev, dt, capacity)
        if trainer.track_best:
            D = trainer.problem.dim
            self.best_loss = torch.full((), float("inf"), dtype=dt, device=dev)
            self.best_X = torch.zeros((M, N + 1, D), dtype=dt, device=dev)
            self.best_Y = torch.zeros((M, N + 1, 1), dtype=dt, device=dev)


class Trainer:
    """Deep-BSDE trainer for one :class:`PDEProblem`.

    Args:
      problem: the PDE.
      M: number of simulated paths (batch).
      N: number of time steps.
      layers: net widths incl. input/output; default ``[D+1, 256×4, 1]``.
      mode / activation: network selection strings ("FC", "Naisnet",
        "Resnet", "Verlet", "SDEnet"; "Sine", "ReLU", "Tanh"). "SDEnet"
        sets ``stochastic_net`` in the automatic config.
      Mm: refinement base; if set, the reference's coarse-to-fine N schedule
        (:class:`TimeStepRefinement`) is applied, one captured iteration per
        distinct N.
      correlation_type: "no_correlation" | "random_correlation" |
        "restricted_random_correlation" — the Cholesky factor that
        correlates the increments.
      correlation_seed: NumPy seed of the random correlation matrix.
      solver_config: :class:`SolverConfig`; None picks ``remat`` by the
        JAX package's rule (remat when the activation stash of a step's
        backward would pass 1 GB in f32, 6 GB under bf16 hidden compute)
        and otherwise the defaults, i.e. (u, Z) by autograd of the net.
        ``SolverConfig(fused_net_u="cuda")`` trains on the kernel pair
        K1 + K2.
      seed: draws the initial weights (on the CPU, so they do not depend on
        the device) and seeds the increments' generator on the device.
      nan_guard: skip updates on non-finite loss.
      track_best: carry the min-loss (X, Y) paths through the chunk (the
        reference's ``min_loss_state``); off by default, since it makes the
        loss stack the paths at every step.
      metrics_file: append one JSON row per log point to this path.
      net_kwargs: passed to the network factory (``gain``,
        ``compute_dtype``).
      antithetic: draw increments in (dW, −dW) pairs; needs an even M.
      ema_decay: keep a Polyak/EMA shadow of the parameters, updated inside
        the chunk (``ema_params``).
      collapse_restart: snapshot (params, optimizer state, EMA) at each
        healthy log point and, when a chunk ends with Y0 pinned at the
        problem's clamp (or non-finite), roll back, re-seed the increments
        and retry, up to ``collapse_max_restarts`` times.
      x0_sampler: ``(generator, M) -> (M, D)`` (``sim.lognormal_x0``,
        ``sim.gaussian_x0``): draw a fresh batch of initial states every
        iteration, after the increments, from the trainer's generator,
        instead of broadcasting ``problem.x0``; under ``antithetic`` M/2
        states are drawn and tiled over both halves, so each mirrored pair
        shares its start. ``y0_log`` then logs Y0 of the first path.
      objective: "global" (the reference's), "local" (backward-induction
        residuals on detached same-parameter targets; required by
        early-exercise problems) or "local_ema" (local, with the targets
        from the EMA shadow before each iteration's update; needs
        ``ema_decay``).
      path_weight_fn, z_match_weight, z_match_mask: the loss options of
        :class:`SolverConfig`, set on the given or the automatic config.
      mesh: a ``DeviceMesh`` with a "dp" dim (and optionally "tp") over the
        ranks of ``parallel.init_distributed``'s group: shard the paths
        (M divisible by the "dp" size) and the wide layers. Every rank
        builds the same Trainer and calls the same methods.
      device: None = the current CUDA card (raises without one); pass "cpu"
        to train on the CPU.
    """

    def __init__(
        self,
        problem: PDEProblem,
        M: int = 100,
        N: int = 50,
        layers: Optional[Sequence[int]] = None,
        mode: str = "FC",
        activation: str = "Sine",
        Mm: Optional[float] = None,
        correlation_type: str = "no_correlation",
        correlation_seed: Optional[int] = 0,
        solver_config: Optional[SolverConfig] = None,
        seed: int = 42,
        mesh=None,
        nan_guard: bool = False,
        track_best: bool = False,
        metrics_file: Optional[str] = None,
        net_kwargs: Optional[dict] = None,
        antithetic: bool = False,
        ema_decay: Optional[float] = None,
        collapse_restart: bool = False,
        collapse_tol: float = 1e-5,
        collapse_max_restarts: int = 3,
        x0_sampler=None,
        objective: str = "global",
        path_weight_fn=None,
        z_match_weight: float = 0.0,
        z_match_mask=None,
        device=None,
    ):
        self.device = default_device(device)
        self.problem = problem
        self.M = int(M)
        self.N = int(N)
        n_samples = getattr(problem, "N_samples", None)
        if n_samples is not None and int(n_samples) != self.N:
            raise ValueError(
                f"{problem.name}: problem.N_samples={n_samples} must equal the Trainer's "
                f"N={self.N} (the per-step accumulation weight in post_step depends on "
                f"it — construct the problem with N_samples={self.N})"
            )
        self.dtype = torch.float32
        self.nan_guard = nan_guard
        if antithetic and self.M % 2:
            raise ValueError(f"antithetic sampling requires even M, got {M}")
        self.antithetic = antithetic
        self.x0_sampler = x0_sampler
        if ema_decay is not None and not (0.0 < ema_decay < 1.0):
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        self.ema_decay = ema_decay
        self.collapse_restart = collapse_restart
        self.collapse_tol = collapse_tol
        self.collapse_max_restarts = collapse_max_restarts
        self.collapse_restarts: list[int] = []  # iteration index per restart
        self.track_best = track_best
        self.metrics_file = metrics_file
        self.mode = mode
        self.activation = activation
        self.layers = list(layers) if layers is not None else default_layers(problem.dim)
        if self.layers[0] != problem.dim + 1:
            raise ValueError(f"layers[0] must be dim+1={problem.dim + 1}, got {self.layers[0]}")
        self.net_kwargs = dict(net_kwargs or {})
        if objective not in ("global", "local", "local_ema"):
            raise ValueError(
                f"objective must be 'global', 'local' or 'local_ema', got {objective!r}")
        self._local_ema = objective == "local_ema"
        if self._local_ema and ema_decay is None:
            raise ValueError("objective='local_ema' requires ema_decay")
        if x0_sampler is not None and objective == "global":
            warnings.warn(
                "x0_sampler with objective='global' is systematically biased for surface "
                "training (~2-volpt IV lift, results_r4/smile_objectives.log); use "
                "objective='local'", UserWarning, stacklevel=2)
        cfg_objective = "local" if self._local_ema else objective
        z_mask = None if z_match_mask is None else tuple(z_match_mask)
        stochastic = mode.lower() == "sdenet"
        if solver_config is None:
            # Auto remat, the JAX package's rule: rematerialize once the
            # no-remat activation stash (N x M x width x 2 len(layers) x
            # itemsize) passes 1 GB in f32; under bf16 hidden compute remat
            # also re-pays the weight casts, so its threshold is 6 GB.
            dtype = self.net_kwargs.get("compute_dtype") or self.dtype
            itemsize = (getattr(torch, dtype) if isinstance(dtype, str) else dtype).itemsize
            act_bytes = self.N * self.M * max(self.layers) * (2 * len(self.layers)) * itemsize
            solver_config = SolverConfig(
                remat=act_bytes > (1e9 if itemsize >= 4 else 6e9), stochastic_net=stochastic,
                objective=cfg_objective,
                path_weight_fn=path_weight_fn, z_match_weight=float(z_match_weight),
                z_match_mask=z_mask)
        else:
            # the JAX Trainer's rules: the arguments override the given config
            # where they are set
            if cfg_objective != "global" and solver_config.objective != cfg_objective:
                solver_config = dataclasses.replace(solver_config, objective=cfg_objective)
            if path_weight_fn is not None:
                solver_config = dataclasses.replace(solver_config, path_weight_fn=path_weight_fn)
            if z_match_weight:
                solver_config = dataclasses.replace(
                    solver_config, z_match_weight=float(z_match_weight), z_match_mask=z_mask)
        self.config = solver_config

        self.net = self._init_net(seed)
        self.mesh = mesh
        names = () if mesh is None else tuple(mesh.mesh_dim_names)
        self._n_dp = axis_size(mesh, DP_AXIS)
        if self.M % self._n_dp:
            raise ValueError(f"batch size M={self.M} must be divisible by the dp mesh "
                             f"axis size {self._n_dp}")
        # the "dp" group and this rank's index in it (None: the batch is not sharded)
        self._dp_group = mesh.get_group(DP_AXIS) if DP_AXIS in names else None
        self._dp_index = mesh.get_local_rank(DP_AXIS) if DP_AXIS in names else 0
        self._flat: dict[int, Tensor] = {}  # the all-reduce's buffers, by size
        self._tp = model_sharding.TP_AXIS in names
        if self._tp:
            model_sharding.shard_params_tp(self.net, mesh)
        groups = [mesh.get_group(n) for n in names]
        self._capturable = all(dist.get_backend(g) == "nccl" for g in groups)
        self._is_main = mesh is None or dist.get_rank() == 0
        self.params = self.net  # the module holds the parameters (JAX: the tree)
        self._params = list(self.net.parameters())
        self._shard_dims = model_sharding.shard_dims(self.net)

        if correlation_type == "no_correlation":
            self.chol = None
            self.correlation = np.eye(problem.noise_dim)
        else:
            self.correlation = generate_correlation_matrix(
                problem.noise_dim, correlation_type, seed=correlation_seed
            )
            self.chol = torch.from_numpy(cholesky_factor(self.correlation)).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._ts = time_grid(self.M, self.N, problem.T, self.dtype, self.device).transpose(0, 1)
        self._X0 = problem.x0.to(self.device).expand(self.M, problem.dim)

        self.loss_fn = make_loss_fn(problem, self.net, self.config)
        self.path_loss_fn = make_path_loss_fn(problem, self.net, self.config)
        self.net_u = make_net_u(self.net, transform=problem.transform_u)
        self.refinement = TimeStepRefinement(Mm=Mm, n_cap=None) if Mm is not None else None

        self.training_loss: list[float] = []
        self.iteration: list[int] = []
        self.y0_log: list[float] = []
        self._tx = None
        self._opt_state: Optional[dict] = None
        self._opt_sig: Optional[tuple] = None
        self._next_it = 0
        self._ema: Optional[torch.nn.Module] = None  # the live shadow, or None
        self._ema_store: Optional[torch.nn.Module] = None  # its tensors, kept across resets
        self._chunk_cache: dict[tuple, _Chunk] = {}

    def _init_net(self, seed: int) -> torch.nn.Module:
        return build_network(
            self.mode, self.layers, self.activation,
            generator=torch.Generator().manual_seed(seed), device=self.device,
            **self.net_kwargs,
        )

    def reset(self, seed: int) -> "Trainer":
        """Re-initialize parameters, optimizer state, random stream, EMA
        shadow and history for a fresh run, in place, KEEPING the captured
        training iterations (as the JAX Trainer keeps its compiled chunks).
        Returns self."""
        self._load_full(dict(self._init_net(seed).named_parameters()))
        self.generator.manual_seed(seed + 1)
        if self._opt_state is not None:  # re-initialized as the next train() would
            with torch.no_grad():
                assign_state(self._opt_state, self._tx.init(self._params))
        self._ema = None
        self._next_it = 0
        self.training_loss, self.iteration, self.y0_log = [], [], []
        self.collapse_restarts = []
        return self

    def warm_start_from(self, other: "Trainer") -> "Trainer":
        """Adopt another trainer's learned state — params, EMA shadow,
        generator state, iteration counter and history — and continue
        training HERE (e.g. on a modified problem). The optimizer state is
        not carried: the next ``train()`` starts it afresh. Returns self."""
        if (self.layers != other.layers or self.mode != other.mode
                or self.activation != other.activation):
            raise ValueError(
                "warm_start_from requires an identical network: "
                f"{self.mode}/{self.activation}/{self.layers} vs "
                f"{other.mode}/{other.activation}/{other.layers}"
            )
        self._load_full(model_sharding.full_state_dict(other.net))
        with torch.no_grad():
            if self._opt_state is not None:
                assign_state(self._opt_state, self._tx.init(self._params))
        self._set_ema(other._ema)
        self.generator.set_state(other.generator.get_state())
        self._next_it = other._next_it
        self.training_loss = list(other.training_loss)
        self.iteration = list(other.iteration)
        self.y0_log = list(other.y0_log)
        return self

    def _load_full(self, state: dict, net: Optional[torch.nn.Module] = None) -> None:
        """Copy full parameters (name -> tensor) into ``net`` (default the
        trained net), into its shards on a "tp" mesh."""
        net = self.net if net is None else net
        if self._tp:
            model_sharding.load_full_state_dict(net, state)
        else:
            net.load_state_dict(state)

    # ------------------------------------------------------------------- EMA
    @property
    def ema_params(self) -> torch.nn.Module:
        """The Polyak/EMA-averaged net (``ema_decay`` must be set): a module
        of the same structure as ``params``, for evaluation and serving."""
        if self.ema_decay is None:
            raise ValueError("Trainer was constructed without ema_decay")
        return self._ema if self._ema is not None else self.net

    def _set_ema(self, source: Optional[torch.nn.Module]) -> None:
        """Make the shadow a copy of ``source`` (None: no shadow yet), in the
        tensors the captured iterations bind."""
        if source is None or self.ema_decay is None:
            self._ema = None
            return
        if self._ema_store is None:
            self._ema_store = copy.deepcopy(self.net).requires_grad_(False)
        with torch.no_grad():
            for e, p in zip(self._ema_store.parameters(), source.parameters()):
                e.copy_(p)
        self._ema = self._ema_store

    def _ensure_ema(self) -> None:
        if self.ema_decay is not None and self._ema is None:
            self._set_ema(self.net)

    # ------------------------------------------------------------------ paths
    def fetch_minibatch(
        self, generator: Optional[torch.Generator] = None, M: Optional[int] = None,
        N: Optional[int] = None,
    ) -> tuple[Tensor, Tensor]:
        """Sample (t, W) with reference shapes (M, N+1, 1), (M, N+1, D) on
        the trainer's device (from its generator unless one is given)."""
        return brownian_paths(
            generator or self.generator, M or self.M, N or self.N,
            self.problem.noise_dim, self.problem.T, self.chol, self.dtype,
        )

    def _increments(self, N: int) -> Tensor:
        """One batch of increments (N, M, D), time-major, from the generator."""
        p = self.problem
        dW = brownian_increments(
            self.generator, self.M, N, p.noise_dim, p.T / N, self.chol, self.dtype,
            antithetic=self.antithetic,
        )
        return dW.transpose(0, 1)

    def _noise(self, shape) -> Tensor:
        """U[0, 1) of ``shape`` from the generator: a stochastic net's noise
        at a training evaluation, drawn after the batch's increments and X0."""
        return torch.rand(shape, generator=self.generator, dtype=self.dtype, device=self.device)

    def _batch(self, chunk: Optional[_Chunk] = None) -> tuple[Tensor, Tensor, Tensor]:
        """One training batch on the trainer's N (or ``chunk``'s) in the
        loss's layout: (ts, dWs, X0), the increments drawn before X0."""
        ts, N = (self._ts, self.N) if chunk is None else (chunk.ts, chunk.N)
        dWs = self._increments(N)
        X0 = draw_x0(self.x0_sampler, self.generator, self.M, self.antithetic, self.dtype)
        return ts, dWs, self._X0 if X0 is None else X0

    # ------------------------------------------------------------- train step
    def _select_optimizer(self, optimizer_type: str, learning_rate: LearningRate,
                          fresh: bool = False) -> None:
        """The JAX Trainer's optimizer and chunk-reuse rules. A new (name,
        lr) starts a fresh optimizer state, as the reference builds a fresh
        optimizer for every ``train`` call that changes them. A float lr
        after a float lr of the same optimizer lives in the state tensor, so
        the fresh state is copied into the captured tensors and the captured
        iterations are kept; another optimizer, or a schedule (whose update
        rule is captured), gets new state tensors and drops them. ``fresh``
        forces a fresh state, as every ``train`` call with a schedule does."""
        schedule = callable(learning_rate)
        sig = (optimizer_type, learning_rate if schedule else float(learning_rate))
        if self._opt_state is not None and self._opt_sig == sig and not fresh:
            return
        tx = build_optimizer(optimizer_type, learning_rate)
        if self._tp:
            if isinstance(tx, LBFGS):
                raise ValueError("LBFGS does not run on a tensor-parallel mesh")
            tx.sq_norm = self._tp_sq_norm
        state = tx.init(self._params)
        prev = self._opt_sig
        if (self._opt_state is None or schedule or prev is None or callable(prev[1])
                or prev[0] != optimizer_type):
            self._chunk_cache.clear()
            self._opt_state = state
        else:
            with torch.no_grad():
                assign_state(self._opt_state, state)
        self._tx = tx
        self._opt_sig = sig

    def _tp_sq_norm(self, grads) -> Tensor:
        """The squared global norm of the gradients on a "tp" mesh: the
        replicated tensors' own, plus the shards' summed over "tp"."""
        dims = self._shard_dims
        sq = sum(torch.sum(g * g) for g, d in zip(grads, dims) if d is None)
        shards = [torch.sum(g * g) for g, d in zip(grads, dims) if d is not None]
        if not shards:
            return sq
        return sq + all_reduce(torch.stack(shards).sum(), self.net.tp_group.pg)

    def _loss_and_grads(self, ts: Tensor, dWs: Tensor, X0: Tensor, paths: bool = False,
                        target=None, noise=None) -> tuple[RolloutResult, list]:
        """The loss of a batch (ts (N+1,M,1), dWs (N,M,D), X0 (M,D)) and its
        gradients. Under a "dp" mesh the loss runs on this rank's rows (a
        stochastic net's noise and the path weights drawn or computed for
        the whole batch, then cut to them), and the loss, the gradients, Y0
        of the batch's first path and, with ``paths``, X and Y come back
        summed over "dp" from one all-reduce."""
        if self._dp_group is None:
            res = self.loss_fn(self.net, ts, dWs, X0, paths=paths, target_params=target,
                               noise=noise)
            return res, list(torch.autograd.grad(res.loss, self._params))
        M = X0.shape[0]
        if M % self._n_dp:
            raise ValueError(f"batch size M={M} must be divisible by the dp mesh axis size "
                             f"{self._n_dp}")
        m = M // self._n_dp
        rows = (self._dp_index * m, m)
        weights = None
        if self.config.path_weight_fn is not None:
            weights = torch.as_tensor(self.config.path_weight_fn(X0)).narrow(0, *rows)
        local_noise = None if noise is None else (
            lambda shape: noise((M,) + tuple(shape[1:])).narrow(0, *rows))
        res = self.loss_fn(self.net, ts.narrow(1, *rows), dWs.narrow(1, *rows),
                           X0.narrow(0, *rows), paths=paths, target_params=target,
                           noise=local_noise, weights=weights)
        grads = torch.autograd.grad(res.loss, self._params)
        first = self._dp_index == 0
        parts = [g.reshape(-1) for g in grads] + [
            res.loss.detach().reshape(1),
            (res.Y0.detach() if first else torch.zeros_like(res.Y0)).reshape(1)]
        if paths:
            for t in (res.X, res.Y):
                full = t.new_zeros((M,) + t.shape[1:])
                full.narrow(0, *rows).copy_(t.detach())
                parts.append(full.reshape(-1))
        sizes = [x.numel() for x in parts]
        n = sum(sizes)
        if n not in self._flat:
            self._flat[n] = torch.empty(n, dtype=self.dtype, device=self.device)
        flat = torch.cat(parts, out=self._flat[n])
        all_reduce(flat, self._dp_group)
        out = flat.split(sizes)
        grads = [v.view_as(g) for v, g in zip(out, grads)]
        # the buffer is reused by the next call: what outlives this iteration is copied
        loss, y0 = out[len(grads)][0].clone(), out[len(grads) + 1][0].clone()
        X = Y = None
        if paths:
            X, Y = (v.view((M,) + t.shape[1:]).clone() for v, t in zip(out[-2:], (res.X, res.Y)))
        return res._replace(loss=loss, Y0=y0, X=X, Y=Y), grads

    def _update(self, ts: Tensor, dWs: Tensor, X0: Tensor, paths: bool = False) -> RolloutResult:
        """One optimizer step on the batch, in place: parameters, optimizer
        state and EMA shadow. Returns the rollout (detached loss and Y0)."""
        params = self._params
        # local_ema: the shadow before this iteration's update is the target net
        target = self._ema if self._local_ema else None
        lbfgs = isinstance(self._tx, LBFGS)
        noise = _NoiseTape(self._noise) if lbfgs else self._noise
        res, grads = self._loss_and_grads(ts, dWs, X0, paths, target, noise)
        with torch.no_grad():
            if lbfgs:
                updates, state = self._tx.update(
                    grads, self._opt_state, params, value=res.loss,
                    value_and_grad=self._value_and_grad(ts, dWs, X0, target, noise))
            else:
                updates, state = self._tx.update(grads, self._opt_state, params)
            # the guard skips the WHOLE update on a non-finite loss, optimizer
            # state and EMA included, else NaN moments poison the next step
            ok = torch.isfinite(res.loss) if self.nan_guard else None
            for p, u in zip(params, updates):
                if ok is None:
                    p.add_(u)
                else:
                    p.copy_(torch.where(ok, p + u, p))
            assign_state(self._opt_state, state, ok)
            if self._ema is not None:
                a = 1.0 - self.ema_decay
                for e, p in zip(self._ema.parameters(), params):
                    new = e + a * (p - e)
                    e.copy_(new if ok is None else torch.where(ok, new, e))
        return res._replace(loss=res.loss.detach(), Y0=res.Y0.detach())

    def _value_and_grad(self, ts: Tensor, dWs: Tensor, X0: Tensor, target=None,
                        noise: Optional[_NoiseTape] = None):
        """``trial params -> (loss, grads)`` on this batch, target and noise,
        for LBFGS's linesearch: the trial values are copied into the net's
        parameters for the evaluation and the current ones copied back."""
        params = self._params
        current = [p.detach().clone() for p in params]

        def value_and_grad(trial):
            with torch.no_grad():
                for p, q in zip(params, trial):
                    p.copy_(q)
            with torch.enable_grad():
                res, grads = self._loss_and_grads(
                    ts, dWs, X0, False, target, None if noise is None else noise.rewind())
                loss = res.loss
            with torch.no_grad():
                for p, q in zip(params, current):
                    p.copy_(q)
            return loss.detach(), grads

        return value_and_grad

    def step(
        self, ts: Tensor, dWs: Tensor, X0: Tensor,
        optimizer_type: str = "Adam", learning_rate: LearningRate = 1e-3,
    ) -> tuple[Tensor, Tensor]:
        """One eager optimizer step on the batch (ts (N+1,M,1), dWs (N,M,D),
        X0 (M,D)), the EMA update included; returns (loss, Y0) as device
        tensors, without a sync. A captured iteration on the trainer's own
        increments (``_batch``) computes the same, bit for bit."""
        self._select_optimizer(optimizer_type, learning_rate)
        self._ensure_ema()
        res = self._update(ts, dWs, X0)
        return res.loss, res.Y0

    def _iteration(self, chunk: _Chunk) -> None:
        """The body of a chunk: draw, step, and log into the chunk's buffers."""
        res = self._update(*self._batch(chunk), paths=self.track_best)
        with torch.no_grad():
            chunk.log(res.loss, res.Y0)
            if self.track_best:
                better = res.loss < chunk.best_loss
                chunk.best_loss.copy_(torch.where(better, res.loss, chunk.best_loss))
                chunk.best_X.copy_(torch.where(better, res.X, chunk.best_X))
                chunk.best_Y.copy_(torch.where(better, res.Y, chunk.best_Y))

    def _get_chunk(self, N: int, optimizer_type: str, k: int) -> _Chunk:
        """The chunk of (N, M, optimizer) and the body's features, as the
        JAX ``_get_chunk`` keys them (lr_token None: the lr lives in the
        state); a new one when the cached buffers hold fewer than k
        iterations (JAX traces a new scan for a new length)."""
        sig = (N, self.M, optimizer_type, None, self.nan_guard, self.ema_decay,
               self.track_best, self.antithetic)
        chunk = self._chunk_cache.get(sig)
        if chunk is None or chunk.capacity < k:
            chunk = self._chunk_cache[sig] = _Chunk(self, N, k)
        return chunk

    def _run_chunk(self, chunk: _Chunk, k: int, it: int) -> None:
        """Run k iterations of ``chunk``, the first numbered ``it``; eagerly
        for LBFGS and over groups that are not all NCCL."""
        if self.track_best:
            chunk.best_loss.fill_(float("inf"))
        chunk.iterate(lambda: self._iteration(chunk), k, it, [self.generator],
                      eager=isinstance(self._tx, LBFGS) or not self._capturable)

    def _read_out(self, chunk: _Chunk, k: int) -> tuple:
        """Start copying a chunk's logs (and best state) to the host; read
        them after ``event`` (None on the CPU)."""
        out = [torch.stack([chunk.losses[:k], chunk.y0s[:k]])]
        if self.track_best:
            out += [chunk.best_loss.clone(), chunk.best_X.clone(), chunk.best_Y.clone()]
        out = [t.to("cpu", non_blocking=True) for t in out]
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return out, event

    # ------------------------------------------------------------------ train
    def train(
        self,
        n_iter: int,
        learning_rate: LearningRate,
        optimizer_type: str = "Adam",
        log_every: int = 100,
        verbose: bool = True,
    ) -> TrainResult:
        """Train for ``n_iter`` iterations. Successive calls continue the
        iteration counter; changing the learning rate or optimizer, or
        passing a schedule ``count -> lr``, starts a fresh optimizer state."""
        with tracing.span("dnnpde.train", it=self._next_it, n_iter=n_iter):
            return self._train(n_iter, learning_rate, optimizer_type, log_every, verbose)

    def _train(self, n_iter: int, learning_rate: LearningRate, optimizer_type: str,
               log_every: int, verbose: bool) -> TrainResult:
        self._select_optimizer(optimizer_type, learning_rate, fresh=callable(learning_rate))
        previous_it = self._next_it
        start = time.time()
        tick = start
        min_loss = float("inf")
        min_state: Optional[tuple[np.ndarray, np.ndarray]] = None
        # One-chunk-deep log pipeline: a chunk's logs are read after the next
        # chunk has been issued, so the host waits while the device works.
        # With collapse_restart the chunk's Y0 is read at once instead.
        pending: list[tuple] = []
        schedule = callable(learning_rate)
        lr_str = "schedule" if schedule else f"{learning_rate:.3e}"
        lr_logged = "schedule" if schedule else learning_rate

        def _drain(keep: int = 0):
            nonlocal min_loss, min_state, tick
            while len(pending) > keep:
                it, b_N, (out, event) = pending.pop(0)
                with tracing.span("dnnpde.train.drain", it=it):
                    with tracing.span("dnnpde.train.wait", it=it):
                        if event is not None:
                            event.synchronize()
                    losses, y0s = out[0].numpy()
                    self.training_loss.append(float(losses.mean()))
                    self.iteration.append(it)
                    y0_last = float(y0s[-1])
                    self.y0_log.append(y0_last)
                    if self.track_best:
                        b_loss = float(out[1])
                        if b_loss < min_loss:
                            min_loss = b_loss
                            min_state = (out[2].numpy(), out[3].numpy())
                    else:
                        min_loss = min(min_loss, float(losses.min()))
                    if self.metrics_file is not None and self._is_main:
                        self._write_metrics(
                            it=it, loss=float(losses[-1]), mean_loss=float(losses.mean()),
                            y0=y0_last, lr=lr_logged, N=b_N, optimizer=optimizer_type,
                            elapsed_s=time.time() - start,
                        )
                    if verbose and self._is_main:
                        now = time.time()
                        print(
                            f"It: {it}, Loss: {losses[-1]:.3e}, Y0: {y0_last:.3f}, "
                            f"Time: {now - tick:.2f}, Learning Rate: {lr_str}, N: {b_N}"
                        )
                        tick = now

        if self.refinement is not None:
            buckets = list(self.refinement.buckets(previous_it, n_iter))
        else:
            buckets = [(previous_it, n_iter, self.N)]
        for b_start, b_len, b_N in buckets:
            done = 0
            while done < b_len:
                k = min(log_every, b_len - done)
                it = b_start + done
                with tracing.span("dnnpde.train.chunk", it=it, k=k):
                    chunk = self._get_chunk(b_N, optimizer_type, k)
                    self._ensure_ema()
                    retry_allowed = (
                        self.collapse_restart
                        and len(self.collapse_restarts) < self.collapse_max_restarts
                    )
                    if retry_allowed:
                        snap = self._snapshot()
                    self._run_chunk(chunk, k, it)
                    if retry_allowed and self._collapsed_y0(float(chunk.y0s[k - 1])):
                        # roll back to the pre-chunk state and retry on a re-seeded
                        # stream; the failed chunk is not logged and does not
                        # advance the iteration counter
                        seed = self._reroll_seed(len(self.collapse_restarts))
                        self._restore(snap)
                        self.generator.manual_seed(seed)
                        self.collapse_restarts.append(it)
                        if verbose and self._is_main:
                            print(
                                f"It: {it}, collapse detected (Y0 pinned) — rolled "
                                f"back, restart {len(self.collapse_restarts)}/"
                                f"{self.collapse_max_restarts}"
                            )
                        continue
                    with tracing.span("dnnpde.train.read_out", it=it):
                        pending.append((it, b_N, self._read_out(chunk, k)))
                _drain(keep=0 if retry_allowed else 1)
                done += k

        _drain(keep=0)
        self._next_it = previous_it + n_iter
        return TrainResult(
            graph=np.stack((np.asarray(self.iteration), np.asarray(self.training_loss))),
            min_loss=min_loss,
            min_loss_state=min_state,
            y0_history=np.asarray(self.y0_log),
            wall_time=time.time() - start,
        )

    def _snapshot(self) -> tuple:
        """Copies of (params, optimizer state, EMA) before a chunk."""
        ema = None if self._ema is None else [e.clone() for e in self._ema.parameters()]
        return [p.detach().clone() for p in self._params], clone_state(self._opt_state), ema

    def _restore(self, snap: tuple) -> None:
        params, state, ema = snap
        with torch.no_grad():
            for p, s in zip(self._params, params):
                p.copy_(s)
            assign_state(self._opt_state, state)
            if ema is not None:
                for e, s in zip(self._ema.parameters(), ema):
                    e.copy_(s)

    def _reroll_seed(self, n: int) -> int:
        """The seed of the stream after the n-th collapse restart: a hash of
        the generator's current state and 7919 + n, as the JAX Trainer folds
        7919 + n into its current key."""
        state = self.generator.get_state().numpy().tobytes()
        digest = hashlib.blake2b(state + (7919 + n).to_bytes(8, "little"), digest_size=8)
        return int.from_bytes(digest.digest(), "little") >> 1

    def _collapsed_y0(self, y0: float) -> bool:
        """Degenerate-trajectory predicate: Y0 pinned at the problem's output
        clamp (the absorbing state) or non-finite."""
        if not np.isfinite(y0):
            return True
        c = self.problem.clamp_u
        return c is not None and abs(y0 - c) <= self.collapse_tol

    def _write_metrics(self, **row) -> None:
        """Append one JSON line per log point."""
        path = Path(self.metrics_file)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def polish(
        self,
        n_iter: int = 400,
        learning_rate: Optional[float] = None,
        M: Optional[int] = None,
        seed: Optional[int] = None,
        from_ema: bool = False,
        antithetic: Optional[bool] = None,
    ) -> np.ndarray:
        """Deterministic LBFGS polish: ``n_iter`` LBFGS steps (zoom
        linesearch) on ONE frozen batch of ``M`` paths (default the
        trainer's M), antithetic by default (M rounded up to even) whatever
        the training setting, drawn from the trainer's generator (or a fresh
        one seeded by ``seed``): increments first, then X0 from
        ``x0_sampler`` (M/2 states tiled under antithetic) or ``problem.x0``.

        Updates the parameters in place, starting from the raw ones or, with
        ``from_ema``, the EMA shadow; the EMA is left as it is. Appends the
        last loss, the iteration and Y0 at x0 to the history and advances
        the iteration counter by ``n_iter``. Runs eagerly with TF32 off (the
        caller's matmul settings restored after). ``learning_rate=None``
        takes the linesearch's step sizes unscaled. Returns the (n_iter,)
        per-step losses."""
        M = int(M or self.M)
        anti = True if antithetic is None else bool(antithetic)
        if anti and M % 2:
            M += 1
        p = self.problem
        N = self.N
        gen = (self.generator if seed is None
               else torch.Generator(device=self.device).manual_seed(int(seed)))
        dWs = brownian_increments(gen, M, N, p.noise_dim, p.T / N, self.chol, self.dtype,
                                  antithetic=anti).transpose(0, 1)
        ts = time_grid(M, N, p.T, self.dtype, self.device).transpose(0, 1)
        X0 = draw_x0(self.x0_sampler, gen, M, anti, self.dtype)
        if X0 is None:
            X0 = p.x0.to(self.device, self.dtype).expand(M, p.dim)
        noise = _NoiseTape(
            lambda shape: torch.rand(shape, generator=gen, dtype=self.dtype, device=self.device))
        return self._polish_on(ts, dWs, X0, n_iter, learning_rate, from_ema, noise)

    def _polish_on(self, ts: Tensor, dWs: Tensor, X0: Tensor, n_iter: int,
                   learning_rate: Optional[float] = None, from_ema: bool = False,
                   noise: Optional[_NoiseTape] = None) -> np.ndarray:
        """:meth:`polish`'s LBFGS steps and bookkeeping on a given batch (and,
        for a stochastic net, one frozen noise tape; None: a fresh one from
        the trainer's generator)."""
        if self._tp:
            raise ValueError("LBFGS does not run on a tensor-parallel mesh")
        params = self._params
        if from_ema:
            with torch.no_grad():
                for q, e in zip(params, self.ema_params.parameters()):
                    q.copy_(e)
        tx = LBFGS(learning_rate)
        state = tx.init(params)
        losses = []
        noise = _NoiseTape(self._noise) if noise is None else noise
        with full_f32_matmul():
            for _ in range(n_iter):
                with torch.enable_grad():
                    res, grads = self._loss_and_grads(ts, dWs, X0, noise=noise.rewind())
                loss = res.loss.detach()
                with torch.no_grad():
                    updates, state = tx.update(
                        grads, state, params, value=loss,
                        value_and_grad=self._value_and_grad(ts, dWs, X0, noise=noise))
                    for q, u in zip(params, updates):
                        q.add_(u)
                losses.append(loss)
        losses = torch.stack(losses).cpu().numpy()
        it = self._next_it
        self._next_it = it + n_iter
        self.training_loss.append(float(losses[-1]))
        self.iteration.append(it)
        u, _ = self.evaluate_u(np.zeros((1, 1)), self.problem.x0.numpy()[None, :])
        self.y0_log.append(float(u[0, 0]))
        return losses

    # ------------------------------------------------------------- checkpoint
    def save_model(self, file_name: str) -> None:
        """Persist params, optimizer state with its signature, iteration
        counter, history, the generator's state and the EMA shadow. A
        schedule's optimizer state is not saved: the schedule cannot be.
        On a mesh every rank calls it: the tensors are gathered whole, rank 0
        writes the file and the others wait for it."""
        saved_sig = None if self._opt_sig is None or callable(self._opt_sig[1]) else self._opt_sig
        full = model_sharding.full_state_dict
        opt_state = None if saved_sig is None else {
            k: model_sharding.gather_full(v, self._shard_dims, self.net)
            if isinstance(v, list) else v for k, v in self._opt_state.items()}
        params, ema = full(self.net), None if self._ema is None else full(self._ema)
        if self._is_main:
            save_checkpoint(
                file_name,
                params=params,
                opt_state=opt_state,
                opt_sig=None if saved_sig is None else list(saved_sig),
                next_it=self._next_it,
                training_loss=self.training_loss,
                iteration=self.iteration,
                y0_log=self.y0_log,
                generator=self.generator.get_state(),
                ema=ema,
            )
        if self.mesh is not None:
            dist.barrier()

    def load_model(self, file_name: str) -> None:
        """Restore a :meth:`save_model` checkpoint into this trainer's
        tensors, so that its next chunk is the one the saved run would have
        run next."""
        state = restore_checkpoint(file_name)
        self._load_full(state["params"])  # copies in place
        saved_sig = state.get("opt_sig")
        if saved_sig is not None and state["opt_state"] is not None:
            self._select_optimizer(saved_sig[0], float(saved_sig[1]))
            opt_state = {k: model_sharding.slice_full(v, self._shard_dims, self.net)
                         if isinstance(v, list) else v for k, v in state["opt_state"].items()}
            with torch.no_grad():
                assign_state(self._opt_state, opt_state)
        self.training_loss = list(state["training_loss"])
        self.iteration = list(state["iteration"])
        self.y0_log = list(state.get("y0_log", []))
        self._next_it = int(state.get("next_it", self.iteration[-1] if self.iteration else 0))
        if state.get("generator") is not None:
            self.generator.set_state(state["generator"])
        if state.get("ema") is not None and self.ema_decay is not None:
            self._set_ema(self.net)
            self._load_full(state["ema"], self._ema)

    # ---------------------------------------------------------------- predict
    def _as_tensor(self, a) -> Tensor:
        return torch.as_tensor(a, dtype=self.dtype).to(self.device)

    def predict(self, Xi_star, t_star, W_star, use_ema: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Run the trained model along given paths → (X_star, Y_star). Does
        not mutate M. ``use_ema=True`` evaluates the EMA shadow (requires
        ``ema_decay``)."""
        net = self.ema_params if use_ema else self.net
        t_star, W_star = self._as_tensor(t_star), self._as_tensor(W_star)
        Xi_star = self._as_tensor(Xi_star).reshape(-1, self.problem.dim)
        M = max(Xi_star.shape[0], t_star.shape[0], W_star.shape[0])
        t_star = t_star.expand((M,) + t_star.shape[1:])
        W_star = W_star.expand((M,) + W_star.shape[1:])
        with torch.no_grad():
            res = self.path_loss_fn(net, t_star, W_star, Xi_star)
        return res.X.cpu().numpy(), res.Y.cpu().numpy()

    def evaluate_u(self, t, X) -> tuple[np.ndarray, np.ndarray]:
        """(u, Z) at arbitrary (t, X) batches."""
        with torch.no_grad():
            u, Z = self.net_u(
                self._as_tensor(t).reshape(-1, 1),
                self._as_tensor(X).reshape(-1, self.problem.dim),
            )
        return u.cpu().numpy(), Z.cpu().numpy()


class TrainingPhases:
    """The reference's two-phase protocol: an initial phase, then a
    fine-tuning phase at a smaller learning rate."""

    def __init__(self, trainer: Trainer, optimizer_type: str = "Adam"):
        self.trainer = trainer
        self.optimizer_type = optimizer_type

    def train_initial_phase(self, n_iter: int = 2000, learning_rate: float = 1e-3) -> TrainResult:
        tic = time.time()
        out = self.trainer.train(n_iter, learning_rate, self.optimizer_type)
        print(f"initial phase: {time.time() - tic:.2f}s")
        return out

    def fine_tuning_phase(self, n_iter: int = 500, learning_rate: float = 1e-5) -> TrainResult:
        tic = time.time()
        out = self.trainer.train(n_iter, learning_rate, self.optimizer_type)
        print(f"fine-tuning phase: {time.time() - tic:.2f}s")
        return out
