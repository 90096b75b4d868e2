"""Multi-seed replica training: K whole training runs advanced in lockstep as
one program, the counterpart of ``dnnpde_tpu/train/replicas.py``.

Each replica has its own initial weights, its own Brownian stream and its
own EMA shadow; all share the multi-phase learning-rate protocol, the
antithetic pairing, the X0 sampler and the objective ("global", "local" or
"local_ema"). Replica k draws what the port's solo ``Trainer(seed=k)``
draws:

- its initial weights from ``torch.Generator().manual_seed(k)`` on the CPU;
- its increments, then its X0 batch, then a stochastic net's noise (one
  draw per evaluation and block, in evaluation order) from a device
  generator seeded ``k + 1``.

The K replicas' weights, optimizer state and EMA shadows are stacked along a
leading replica axis (name → (K, …), the layout of
``torch.func.stack_module_state``). One iteration draws each replica's batch
from its own generator (``torch.func.vmap`` takes no generator, so the
draws stay outside it), then runs ``vmap`` over the replicas of
``grad_and_value`` of the loss and of the optimizer's update: the gradient,
the clipping at the global norm, Adam's moments and bias correction are
each replica's own, as the reference vmaps ``tx.update``. Z = ∇ₓu comes
from ``torch.func.vjp`` (``solver.bsde.make_functional_net_u``), since
``torch.autograd.grad`` cannot run under ``vmap``. The update and the EMA
are then applied in place to the stacked tensors.

As in the port's ``Trainer``, every tensor the iteration touches keeps its
address, so on a CUDA device the iteration is captured once into a CUDA
graph with all K generators registered, and a chunk is that many replays.
The learning rates live in a (K,) device tensor, so every phase replays the
same captured iteration. Replicas run the f32 autograd net_u; the reference
runs its replica program without the fused kernels too.
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
from dnnpde_tpu_torch.sim.brownian import brownian_increments, time_grid
from dnnpde_tpu_torch.solver.bsde import SolverConfig, make_loss_fn, make_net_u
from dnnpde_tpu_torch.train.diagnostics import anomalies_checked
from dnnpde_tpu_torch.train.optimizers import Optimizer
from dnnpde_tpu_torch.train.trainer import _assign

Tensor = torch.Tensor

PRECONDITIONERS = ("adam", "rmsprop", "sgd", "adamax")


@dataclasses.dataclass
class ReplicaResult:
    """K training runs' worth of artifacts, replica axis leading."""

    params: dict  # name -> (K, ...)
    ema_params: dict  # name -> (K, ...); the params when there is no EMA
    losses: np.ndarray  # (K, n_logs): the last iteration's loss of each chunk
    y0s: np.ndarray  # (K, n_logs)
    seeds: tuple
    wall_time: float
    compile_time: float


class _Functional:
    """``net`` evaluated under the parameter dict ``params`` (one replica's,
    inside ``vmap``): the module interface the loss calls."""

    def __init__(self, net: torch.nn.Module, params: dict):
        self.net, self.params = net, params

    def __call__(self, inp: Tensor, noise=None) -> Tensor:
        args = (inp,) if noise is None else (inp, noise)
        return torch.func.functional_call(self.net, self.params, args)

    def draw_noise(self, draw, batch: int):
        return self.net.draw_noise(draw, batch)


def replica_net(stacked: dict, k: int, layers: Sequence[int], mode: str = "FC",
                activation: str = "Sine", net_kwargs: Optional[dict] = None) -> torch.nn.Module:
    """Replica k of a stacked parameter dict (name → (K, …)) as a port
    module of the given structure, on the stack's device."""
    device = next(iter(stacked.values())).device
    net = build_network(mode, layers, activation, generator=torch.Generator().manual_seed(0),
                        device=device, **(net_kwargs or {}))
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(stacked[name][k])
    return net


class ReplicaProgram:
    """The training iteration of K replicas on stacked tensors that keep
    their addresses (see the module docstring). ``capacity`` iterations of
    (K,) losses and Y0s are logged per chunk, at a device-side index.

    ``step(dWs, X0, noise)`` is one eager iteration on given draws (tests
    feed recorded ones); ``iteration()`` draws from the replicas' generators
    and logs; ``run(k)`` runs k iterations, on a CUDA device as replays of
    one captured iteration (the first iteration of the program is an eager
    warm-up, the second is captured)."""

    def __init__(
        self,
        problem: PDEProblem,
        seeds: Sequence[int],
        M: int = 100,
        N: int = 50,
        layers: Optional[Sequence[int]] = None,
        mode: str = "FC",
        activation: str = "Sine",
        optimizer_type: str = "Adam",
        clip_norm: Optional[float] = 1.0,
        ema_decay: Optional[float] = None,
        x0_sampler=None,
        antithetic: bool = False,
        objective: str = "global",
        config: Optional[SolverConfig] = None,
        net_kwargs: Optional[dict] = None,
        capacity: int = 1,
        device=None,
    ):
        if objective not in ("global", "local", "local_ema"):
            raise ValueError(
                "train_replicas supports objective 'global', 'local' or "
                f"'local_ema' (got {objective!r})")
        self.local_ema = objective == "local_ema"
        if self.local_ema and ema_decay is None:
            raise ValueError("objective='local_ema' requires ema_decay")
        if antithetic and M % 2:
            raise ValueError(f"antithetic requires even M, got {M}")
        key = optimizer_type.lower()
        if key not in PRECONDITIONERS:
            raise ValueError(
                f"replicas support {sorted(PRECONDITIONERS)}, got {optimizer_type!r}")
        self.device = dev = default_device(device)
        self.problem = problem
        self.seeds = tuple(int(s) for s in seeds)
        self.K = K = len(self.seeds)
        self.M, self.N = int(M), int(N)
        self.layers = list(layers) if layers is not None else [problem.dim + 1] + [256] * 4 + [1]
        self.mode, self.activation = mode, activation
        self.net_kwargs = dict(net_kwargs or {})
        self.antithetic, self.x0_sampler, self.ema_decay = antithetic, x0_sampler, ema_decay
        cfg_objective = "local" if self.local_ema else objective
        stochastic = mode.lower() == "sdenet"
        cfg = config or SolverConfig(remat=False, objective=cfg_objective,
                                     stochastic_net=stochastic)
        if cfg.objective != cfg_objective:
            cfg = dataclasses.replace(cfg, objective=cfg_objective)
        self.config = cfg

        nets = [build_network(mode, self.layers, activation,
                              generator=torch.Generator().manual_seed(s), device=dev,
                              **self.net_kwargs) for s in self.seeds]
        self.net = nets[0]  # the structure functional_call evaluates
        stacked, _ = torch.func.stack_module_state(nets)
        self.params = {n: p.detach() for n, p in stacked.items()}
        self._names = list(self.params)
        self.ema = ({n: p.clone() for n, p in self.params.items()}
                    if ema_decay is not None else None)
        self.tx = Optimizer(key, 0.0, clip_norm)  # the rate rides the iteration (self.lr)
        self.opt_state = self._fresh_state()
        self.lr = torch.zeros(K, dtype=torch.float32, device=dev)
        self.generators = [torch.Generator(device=dev).manual_seed(s + 1) for s in self.seeds]
        self.ts = time_grid(self.M, self.N, problem.T, torch.float32, dev).transpose(0, 1)
        self.X0 = problem.x0.to(dev).expand(self.M, problem.dim)
        self.loss_fn = make_loss_fn(problem, self.net, cfg, functional=True)
        self._noise_shapes = ([s for _ in range(self.N + 1) for s in self.net.noise_shapes(self.M)]
                              if cfg.stochastic_net else [])

        self.capacity = int(capacity)
        self.losses = torch.zeros((self.capacity, K), dtype=torch.float32, device=dev)
        self.y0s = torch.zeros((self.capacity, K), dtype=torch.float32, device=dev)
        self.idx = torch.zeros(1, dtype=torch.long, device=dev)
        self.it = torch.zeros((), dtype=torch.long, device=dev)  # iterations since the start
        self.lr_switch: Optional[tuple[Tensor, Tensor, Tensor]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.warm = False
        self.compile_time = 0.0
        self._side_stream = None

    # ------------------------------------------------------------------ state
    def _fresh_state(self) -> dict:
        """The optimizer's initial state on the stacked parameters, with a
        per-replica (K,) step count."""
        state = self.tx.init([self.params[n] for n in self._names])
        state.pop("lr")
        state["count"] = torch.zeros(self.K, dtype=torch.int32, device=self.device)
        return state

    def new_phase(self, learning_rates) -> None:
        """Start a phase: the optimizer state re-initialized in place (as
        each ``Trainer.train`` call with a new rate starts afresh) and the
        rate(s), one number or one per replica, copied into ``lr``."""
        with torch.no_grad():
            _assign(self.opt_state, self._fresh_state())
            self.lr.copy_(torch.as_tensor(learning_rates, dtype=torch.float32).expand(self.K))

    # -------------------------------------------------------------- iteration
    def _value_and_grad_one(self, params, ema, dWs, X0, noise):
        """One replica's gradient, loss and Y0 (under ``vmap``)."""

        def loss_of(p):
            draws = iter(noise)
            target = _Functional(self.net, ema) if self.local_ema else None
            res = self.loss_fn(_Functional(self.net, p), self.ts, dWs, X0, paths=False,
                               target_params=target, noise=lambda shape: next(draws))
            return res.loss, res.Y0

        grads, (loss, y0) = torch.func.grad_and_value(loss_of, has_aux=True)(params)
        return grads, loss, y0

    def _member(self, params, state, ema, lr, dWs, X0, noise):
        """One replica's gradient and optimizer update (under ``vmap``)."""
        names = self._names
        grads, loss, y0 = self._value_and_grad_one(params, ema, dWs, X0, noise)
        updates, new = self.tx.update([grads[n] for n in names], {**state, "lr": lr},
                                      [params[n] for n in names])
        new.pop("lr")
        return updates, new, loss, y0

    def draw(self) -> tuple[Tensor, Optional[Tensor], list]:
        """Each replica's batch from its own generator, in the solo Trainer's
        order: increments (K, N, M, Dw), X0 (K, M, D) (None: ``problem.x0``
        broadcast), and a stochastic net's noise, one (K, …) tensor per draw."""
        p, M, N = self.problem, self.M, self.N
        dWs, X0s, noise = [], [], []
        for g in self.generators:
            dWs.append(brownian_increments(g, M, N, p.noise_dim, p.T / N, None, torch.float32,
                                           antithetic=self.antithetic).transpose(0, 1))
            if self.x0_sampler is not None:
                if self.antithetic:
                    half = self.x0_sampler(g, M // 2).to(torch.float32)
                    X0s.append(torch.cat([half, half], dim=0))
                else:
                    X0s.append(self.x0_sampler(g, M).to(torch.float32))
            noise.append([torch.rand(s, generator=g, dtype=torch.float32, device=self.device)
                          for s in self._noise_shapes])
        X0 = torch.stack(X0s) if X0s else None
        return torch.stack(dWs), X0, [torch.stack(d) for d in zip(*noise)]

    def step(self, dWs: Tensor, X0: Optional[Tensor] = None, noise: Sequence[Tensor] = ()):
        """One eager iteration of all replicas on the given draws; updates the
        parameters, optimizer state and EMA shadows in place and returns the
        (K,) losses and Y0s."""
        vmapped = torch.func.vmap(self._member,
                                  in_dims=(0, 0, 0, 0, 0, None if X0 is None else 0, 0))
        updates, new, loss, y0 = vmapped(self.params, self.opt_state,
                                         self.ema if self.local_ema else {}, self.lr, dWs,
                                         self.X0 if X0 is None else X0, list(noise))
        with torch.no_grad():
            for n, u in zip(self._names, updates):
                self.params[n].add_(u)
            _assign(self.opt_state, new)
            if self.ema is not None:
                a = 1.0 - self.ema_decay
                for n in self._names:
                    e = self.ema[n]
                    e.copy_(e + a * (self.params[n] - e))
        return loss.detach(), y0.detach()

    def iteration(self) -> None:
        """Draw, step, and log at the device-side index."""
        if self.lr_switch is not None:
            n1, lr1, lr2 = self.lr_switch
            self.lr.copy_(torch.where(self.it < n1, lr1, lr2))
        loss, y0 = self.step(*self.draw())
        with torch.no_grad():
            self.losses.index_copy_(0, self.idx, loss[None])
            self.y0s.index_copy_(0, self.idx, y0[None])
            self.idx.add_(1)
            self.it.add_(1)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        try:
            with torch.cuda.graph(graph, stream=self._side_stream):
                self.iteration()
        except RuntimeError as e:
            raise RuntimeError(
                "capturing the replica iteration into a CUDA graph failed; the iteration "
                "must run on the device without host reads or synchronization") from e
        self.graph = graph

    def run(self, k: int) -> None:
        """k iterations, logged from index 0 (k ≤ ``capacity``)."""
        if k > self.capacity:
            raise ValueError(f"a chunk of {k} iterations exceeds the capacity {self.capacity}")
        self.idx.zero_()
        if self.device.type != "cuda" or anomalies_checked():
            for _ in range(k):
                t0 = time.perf_counter()
                self.iteration()
                if not self.warm:
                    self.compile_time, self.warm = time.perf_counter() - t0, True
            return
        done = 0
        with torch.cuda.device(self.device):
            if self.graph is None and k > 0:
                torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                if self._side_stream is None:
                    self._side_stream = torch.cuda.Stream(self.device)
                main = torch.cuda.current_stream(self.device)
                if not self.warm:  # the warm-up: a real iteration, eager, on the side stream
                    self._side_stream.wait_stream(main)
                    with torch.cuda.stream(self._side_stream):
                        self.iteration()
                    main.wait_stream(self._side_stream)
                    self.warm = True
                    done = 1
                if done < k:
                    self._capture()
                torch.cuda.synchronize(self.device)
                self.compile_time = time.perf_counter() - t0
            for _ in range(k - done):
                self.graph.replay()

    def logs(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """The chunk's (k, K) losses and Y0s on the host."""
        out = torch.stack([self.losses[:k], self.y0s[:k]]).cpu().numpy()
        return out[0], out[1]


def train_replicas(
    problem: PDEProblem,
    seeds: Sequence[int],
    phases: Sequence[tuple[int, float]],
    M: int = 100,
    N: int = 50,
    layers: Optional[Sequence[int]] = None,
    mode: str = "FC",
    activation: str = "Sine",
    optimizer_type: str = "Adam",
    clip_norm: float = 1.0,
    ema_decay: Optional[float] = None,
    x0_sampler=None,
    antithetic: bool = False,
    objective: str = "global",
    config: Optional[SolverConfig] = None,
    log_every: int = 2000,
    net_kwargs: Optional[dict] = None,
    device=None,
) -> ReplicaResult:
    """Train ``len(seeds)`` replicas of the same configuration as one program.

    ``phases``: the (n_iter, lr) anneal, e.g. ``[(10000, 1e-3), (5000,
    1e-4), (5000, 1e-5)]``. The optimizer state is re-initialized at each
    phase boundary, as each ``Trainer.train`` call with a new rate starts a
    fresh state. Each chunk of ``log_every`` iterations logs its last
    iteration's loss and Y0 per replica. ``device``: None = the first CUDA
    card (raises without one); "cpu" trains on the CPU.
    """
    capacity = max(min(log_every, int(n)) for n, _ in phases)
    prog = ReplicaProgram(
        problem, seeds, M=M, N=N, layers=layers, mode=mode, activation=activation,
        optimizer_type=optimizer_type, clip_norm=clip_norm, ema_decay=ema_decay,
        x0_sampler=x0_sampler, antithetic=antithetic, objective=objective, config=config,
        net_kwargs=net_kwargs, capacity=capacity, device=device)
    losses_log, y0s_log = [], []
    t_start = time.perf_counter()
    for n_iter, lr in phases:
        prog.new_phase(lr)
        done = 0
        while done < n_iter:
            k = min(log_every, n_iter - done)
            prog.run(k)
            losses, y0s = prog.logs(k)
            losses_log.append(losses[-1])
            y0s_log.append(y0s[-1])
            done += k
    wall = time.perf_counter() - t_start
    params = {n: p.clone() for n, p in prog.params.items()}
    return ReplicaResult(
        params=params,
        ema_params=({n: e.clone() for n, e in prog.ema.items()} if prog.ema is not None
                    else params),
        losses=np.stack(losses_log, axis=1),
        y0s=np.stack(y0s_log, axis=1),
        seeds=prog.seeds,
        wall_time=wall,
        compile_time=prog.compile_time,
    )


def replica_values_at(
    problem: PDEProblem,
    result: ReplicaResult,
    t: float = 0.0,
    X=None,
    mode: str = "FC",
    activation: str = "Sine",
    layers: Optional[Sequence[int]] = None,
    use_ema: bool = True,
    net_kwargs: Optional[dict] = None,
) -> np.ndarray:
    """u(t, X) per replica, the per-seed headline read (EMA by default).
    Returns (K, B) values for X of shape (B, D) (default: the problem's x0),
    evaluated on the device of the result's tensors (a stochastic net under
    its fixed evaluation noise)."""
    layers = list(layers) if layers is not None else [problem.dim + 1] + [256] * 4 + [1]
    stacked = result.ema_params if use_ema else result.params
    device = next(iter(stacked.values())).device
    if X is None:
        X = problem.x0.numpy()[None, :]
    X = torch.as_tensor(np.asarray(X, np.float32), device=device)
    tt = torch.full((X.shape[0], 1), float(t), dtype=torch.float32, device=device)
    out = []
    with torch.no_grad():
        for k in range(len(result.seeds)):
            net = replica_net(stacked, k, layers, mode, activation, net_kwargs)
            u, _ = make_net_u(net, transform=problem.transform_u)(tt, X)
            out.append(u[:, 0])
    return torch.stack(out).cpu().numpy()
