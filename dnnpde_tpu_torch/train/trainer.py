"""Trainer: the user-facing deep-BSDE training loop of the PyTorch port, the
counterpart of ``dnnpde_tpu/train/trainer.py``.

- The training loop runs in chunks of ``log_every`` iterations. Inside a
  chunk nothing is read back to the host: increments are drawn on the
  device from a ``torch.Generator``, each step's loss and Y0 go into device
  tensors, and the optimizer (``train/optimizers.py``) and the NaN guard use
  ``torch.where``. The chunk's values are read once, at its log point.
- ``predict`` does not mutate the batch size.
- Optional NaN guard: skip the whole update, optimizer state included, when
  the loss is non-finite.

What the JAX Trainer has beyond this (time-step refinement, sampled X0,
EMA, the local objective, best-state tracking, collapse restarts, meshes,
metrics files, LBFGS polish, checkpoints, ``TrainingPhases``) is not ported
yet and raises ``NotImplementedError`` (ROADMAP.md Queue 1, item 1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dnnpde_tpu_torch.nets import build_network
from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.runtime import default_device
from dnnpde_tpu_torch.sim.brownian import brownian_increments, brownian_paths, time_grid
from dnnpde_tpu_torch.sim.correlation import cholesky_factor, generate_correlation_matrix
from dnnpde_tpu_torch.solver.bsde import (
    RolloutResult,
    SolverConfig,
    make_loss_fn,
    make_net_u,
    make_path_loss_fn,
)
from dnnpde_tpu_torch.train.optimizers import build_optimizer

Tensor = torch.Tensor

_LATER = "is not ported yet (ROADMAP.md Queue 1, item 1: optimizers and trainer core)"


@dataclasses.dataclass
class TrainResult:
    """Mirror of the reference ``train`` return: (graph, min_loss, min_loss_state)."""

    graph: np.ndarray  # (2, num_logs): iterations; mean losses
    min_loss: float
    min_loss_state: Optional[tuple[np.ndarray, np.ndarray]]  # best (X, Y); not tracked yet
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


class Trainer:
    """Deep-BSDE trainer for one :class:`PDEProblem`.

    Args:
      problem: the PDE.
      M: number of simulated paths (batch).
      N: number of time steps.
      layers: net widths incl. input/output; default ``[D+1, 256×4, 1]``.
      mode / activation: network selection strings ("FC" only so far).
      correlation_type: "no_correlation" | "random_correlation" |
        "restricted_random_correlation" — the Cholesky factor that
        correlates the increments.
      correlation_seed: NumPy seed of the random correlation matrix.
      solver_config: :class:`SolverConfig`; None picks ``remat`` by the
        JAX package's rule (remat when the activation stash of a step's
        backward would pass 1 GB) and otherwise the defaults, i.e. (u, Z)
        by autograd of the net. ``SolverConfig(fused_net_u="cuda")`` trains
        on the kernel pair K1 + K2.
      seed: draws the initial weights (on the CPU, so they do not depend on
        the device) and seeds the increments' generator on the device.
      nan_guard: skip updates on non-finite loss.
      antithetic: draw increments in (dW, −dW) pairs; needs an even M.
      device: None = the first CUDA card (raises without one); pass "cpu"
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
        x0_sampler=None,
        objective: str = "global",
        path_weight_fn=None,
        z_match_weight: float = 0.0,
        z_match_mask=None,
        device=None,
    ):
        later = {
            "Mm": Mm is not None, "mesh": mesh is not None, "track_best": track_best,
            "metrics_file": metrics_file is not None, "net_kwargs": bool(net_kwargs),
            "ema_decay": ema_decay is not None, "collapse_restart": collapse_restart,
            "x0_sampler": x0_sampler is not None, "objective": objective != "global",
            "path_weight_fn": path_weight_fn is not None,
            "z_match_weight": bool(z_match_weight) or z_match_mask is not None,
        }
        for name, used in later.items():
            if used:
                raise NotImplementedError(f"Trainer({name}=...) {_LATER}")
        self.device = default_device(device)
        self.problem = problem
        self.M = int(M)
        self.N = int(N)
        self.dtype = torch.float32
        self.nan_guard = nan_guard
        if antithetic and self.M % 2:
            raise ValueError(f"antithetic sampling requires even M, got {M}")
        self.antithetic = antithetic
        self.mode = mode
        self.activation = activation
        self.layers = list(layers) if layers is not None else default_layers(problem.dim)
        if self.layers[0] != problem.dim + 1:
            raise ValueError(f"layers[0] must be dim+1={problem.dim + 1}, got {self.layers[0]}")
        if solver_config is None:
            # Auto remat, the JAX package's rule: rematerialize once the
            # no-remat activation stash (N x M x width x 2 len(layers) f32)
            # passes 1 GB.
            act_bytes = self.N * self.M * max(self.layers) * (2 * len(self.layers)) * 4
            solver_config = SolverConfig(remat=act_bytes > 1e9)
        self.config = solver_config

        self.net = build_network(
            mode, self.layers, activation,
            generator=torch.Generator().manual_seed(seed), device=self.device,
        )
        self.params = self.net  # the module holds the parameters (JAX: the tree)

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

        self.training_loss: list[float] = []
        self.iteration: list[int] = []
        self.y0_log: list[float] = []
        self._tx = None
        self._opt_state = None
        self._opt_sig: Optional[tuple] = None
        self._next_it = 0

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

    def _batch(self) -> tuple[Tensor, Tensor, Tensor]:
        """One training batch in the loss's layout: (ts, dWs, X0)."""
        p = self.problem
        dW = brownian_increments(
            self.generator, self.M, self.N, p.noise_dim, p.T / self.N, self.chol, self.dtype,
            antithetic=self.antithetic,
        )
        return self._ts, dW.transpose(0, 1), self._X0

    # ------------------------------------------------------------- train step
    def _select_optimizer(self, optimizer_type: str, learning_rate: float) -> None:
        """Fresh optimizer state when (name, lr) changes, as the reference
        builds a fresh optimizer for every ``train`` call that changes them."""
        sig = (optimizer_type, learning_rate)
        if self._opt_sig != sig:
            self._tx = build_optimizer(optimizer_type, learning_rate)
            self._opt_state = self._tx.init(list(self.params.parameters()))
            self._opt_sig = sig

    def step(
        self, ts: Tensor, dWs: Tensor, X0: Tensor,
        optimizer_type: str = "Adam", learning_rate: float = 1e-3,
    ) -> tuple[Tensor, Tensor]:
        """One optimizer step on the batch (ts (N+1,M,1), dWs (N,M,D),
        X0 (M,D)); returns (loss, Y0) as device tensors, without a sync."""
        self._select_optimizer(optimizer_type, learning_rate)
        params = list(self.params.parameters())
        res: RolloutResult = self.loss_fn(self.params, ts, dWs, X0)
        grads = torch.autograd.grad(res.loss, params)
        with torch.no_grad():
            updates, state = self._tx.update(grads, self._opt_state, params)
            if self.nan_guard:
                # skip the WHOLE update on a non-finite loss, optimizer state
                # included, else NaN moments poison the next finite step
                ok = torch.isfinite(res.loss)
                for p, u in zip(params, updates):
                    p.copy_(torch.where(ok, p + u, p))
                state = {
                    k: ([torch.where(ok, n, o) for n, o in zip(v, self._opt_state[k])]
                        if isinstance(v, list) else torch.where(ok, v, self._opt_state[k]))
                    for k, v in state.items()
                }
            else:
                for p, u in zip(params, updates):
                    p.add_(u)
        self._opt_state = state
        return res.loss.detach(), res.Y0.detach()

    # ------------------------------------------------------------------ train
    def train(
        self,
        n_iter: int,
        learning_rate: float,
        optimizer_type: str = "Adam",
        log_every: int = 100,
        verbose: bool = True,
    ) -> TrainResult:
        """Train for ``n_iter`` iterations. Successive calls continue the
        iteration counter; changing the learning rate or optimizer resets
        the optimizer state."""
        self._select_optimizer(optimizer_type, learning_rate)
        start = time.time()
        tick = start
        min_loss = float("inf")
        done = 0
        while done < n_iter:
            k = min(log_every, n_iter - done)
            losses = torch.empty(k, dtype=self.dtype, device=self.device)
            y0s = torch.empty(k, dtype=self.dtype, device=self.device)
            for i in range(k):
                losses[i], y0s[i] = self.step(*self._batch(), optimizer_type, learning_rate)
            it = self._next_it + done
            logged = torch.stack([losses, y0s]).cpu().numpy()  # the chunk's one read
            self.training_loss.append(float(logged[0].mean()))
            self.iteration.append(it)
            self.y0_log.append(float(logged[1, -1]))
            min_loss = min(min_loss, float(logged[0].min()))
            if verbose:
                now = time.time()
                print(
                    f"It: {it}, Loss: {logged[0, -1]:.3e}, Y0: {logged[1, -1]:.3f}, "
                    f"Time: {now - tick:.2f}, Learning Rate: {learning_rate:.3e}, N: {self.N}"
                )
                tick = now
            done += k
        self._next_it += n_iter
        return TrainResult(
            graph=np.stack((np.asarray(self.iteration), np.asarray(self.training_loss))),
            min_loss=min_loss,
            min_loss_state=None,
            y0_history=np.asarray(self.y0_log),
            wall_time=time.time() - start,
        )

    def polish(self, *args, **kwargs):
        raise NotImplementedError(f"Trainer.polish (LBFGS) {_LATER}")

    def save_model(self, file_name: str) -> None:
        raise NotImplementedError(f"Trainer.save_model {_LATER}")

    def load_model(self, file_name: str) -> None:
        raise NotImplementedError(f"Trainer.load_model {_LATER}")

    # ---------------------------------------------------------------- predict
    def _as_tensor(self, a) -> Tensor:
        return torch.as_tensor(a, dtype=self.dtype).to(self.device)

    def predict(self, Xi_star, t_star, W_star) -> tuple[np.ndarray, np.ndarray]:
        """Run the trained model along given paths → (X_star, Y_star). Does
        not mutate M."""
        t_star, W_star = self._as_tensor(t_star), self._as_tensor(W_star)
        Xi_star = self._as_tensor(Xi_star).reshape(-1, self.problem.dim)
        M = max(Xi_star.shape[0], t_star.shape[0], W_star.shape[0])
        t_star = t_star.expand((M,) + t_star.shape[1:])
        W_star = W_star.expand((M,) + W_star.shape[1:])
        with torch.no_grad():
            res = self.path_loss_fn(self.params, t_star, W_star, Xi_star)
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
    """The reference's two-phase training protocol; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"TrainingPhases {_LATER}")
