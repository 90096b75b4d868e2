"""Optimizer factory of the port: the reference's string-selected optimizers,
written out so that each step is the one the JAX package's optax chain
takes (``dnnpde_tpu/train/optimizers.py``).

``torch.optim`` differs from optax in several defaults (RMSprop decays at
0.99 with eps outside the square root; Adagrad starts its accumulator at 0;
AdamW decays weights at 1e-2; Adamax adds eps inside the max; and
``clip_grad_norm_`` scales by clip / (norm + 1e-6)), so every rule here is an
explicit update on a list of tensors with optax's constants:

- clipping: ``clip_by_global_norm(1.0)`` first, for every optimizer: scale
  by clip / norm when the global norm is at least clip;
- the learning rate is a runtime value kept in the state, as
  ``optax.inject_hyperparams`` keeps it. A schedule is a callable that
  takes the state's ``count`` (a 0-d int32 tensor on the parameters'
  device: the number of updates taken so far) and returns the rate as a
  tensor; it is evaluated on the device at every update, so it runs inside
  a captured training iteration, as optax evaluates it inside the jitted
  chunk;
- ASGD maps to plain SGD (torch's ASGD takes SGD steps and only keeps a
  side average);
- LBFGS (optax's zoom-linesearch LBFGS) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

Tensor = torch.Tensor
LearningRate = Union[float, Callable[[Tensor], Tensor]]

OPTIMIZER_NAMES = (
    "Adam",
    "SGD",
    "RMSprop",
    "AdamW",
    "Adadelta",
    "Adagrad",
    "Adamax",
    "ASGD",
    "LBFGS",
)

# name -> (state slots, initial value of each slot)
_SLOTS = {
    "adam": {"mu": 0.0, "nu": 0.0},
    "adamw": {"mu": 0.0, "nu": 0.0},
    "sgd": {},
    "asgd": {},
    "rmsprop": {"nu": 0.0},
    "adagrad": {"sum_of_squares": 0.1},
    "adadelta": {"e_g": 0.0, "e_x": 0.0},
    "adamax": {"mu": 0.0, "nu": 0.0},
}
B1, B2, EPS = 0.9, 0.999, 1e-8  # adam, adamw, adamax
ADAMW_DECAY = 1e-4
RMS_DECAY = 0.9
ADAGRAD_EPS = 1e-7
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6


def is_lbfgs(optimizer_type: str) -> bool:
    return optimizer_type.lower() == "lbfgs"


class Optimizer:
    """A gradient transformation on a list of tensors, in optax's form:
    ``state = opt.init(params)``, then ``updates, state = opt.update(grads,
    state, params)`` and ``params + updates``. Nothing reads a value back to
    the host, so a loop of steps never waits for the device."""

    def __init__(self, name: str, learning_rate: LearningRate, clip_norm: Optional[float]):
        self.name = name
        self.schedule = learning_rate if callable(learning_rate) else None
        self.learning_rate = learning_rate if self.schedule else float(learning_rate)
        self.clip_norm = clip_norm

    def _lr(self, count: Tensor) -> Tensor:
        """The schedule's rate at ``count``, as an f32 tensor beside it."""
        return torch.as_tensor(self.schedule(count), dtype=torch.float32, device=count.device)

    def init(self, params: Sequence[Tensor]) -> dict:
        dev = params[0].device
        count = torch.zeros((), dtype=torch.int32, device=dev)
        state = {
            "count": count,
            "lr": (self._lr(count) if self.schedule else
                   torch.tensor(self.learning_rate, dtype=torch.float32, device=dev)),
        }
        for slot, value in _SLOTS[self.name].items():
            state[slot] = [torch.full_like(p, value) for p in params]
        return state

    def update(self, grads: Sequence[Tensor], state: dict, params: Sequence[Tensor]):
        """(updates, new state); the inputs are not modified."""
        g = list(grads)
        if self.clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            keep = norm < self.clip_norm
            g = [torch.where(keep, x, (x / norm) * self.clip_norm) for x in g]
        lr = self._lr(state["count"]) if self.schedule else state["lr"]
        count = state["count"] + 1
        new = {"count": count, "lr": lr}
        name = self.name
        if name in ("adam", "adamw"):
            new["mu"] = [(1 - B1) * x + B1 * m for x, m in zip(g, state["mu"])]
            new["nu"] = [(1 - B2) * x**2 + B2 * v for x, v in zip(g, state["nu"])]
            c1, c2 = 1 - B1**count, 1 - B2**count
            u = [(m / c1) / (torch.sqrt(v / c2) + EPS) for m, v in zip(new["mu"], new["nu"])]
            if name == "adamw":
                u = [x + ADAMW_DECAY * p for x, p in zip(u, params)]
        elif name in ("sgd", "asgd"):
            u = g
        elif name == "rmsprop":
            new["nu"] = [(1 - RMS_DECAY) * x**2 + RMS_DECAY * v for x, v in zip(g, state["nu"])]
            u = [torch.rsqrt(v + EPS) * x for x, v in zip(g, new["nu"])]
        elif name == "adagrad":
            new["sum_of_squares"] = [x**2 + s for x, s in zip(g, state["sum_of_squares"])]
            u = [torch.where(s > 0, torch.rsqrt(s + ADAGRAD_EPS), 0.0) * x
                 for x, s in zip(g, new["sum_of_squares"])]
        elif name == "adadelta":
            rho, eps = ADADELTA_RHO, ADADELTA_EPS
            new["e_g"] = [(1 - rho) * x**2 + rho * e for x, e in zip(g, state["e_g"])]
            u = [(torch.sqrt(ex + eps) / torch.sqrt(eg + eps)) * x
                 for x, eg, ex in zip(g, new["e_g"], state["e_x"])]
            new["e_x"] = [(1 - rho) * x**2 + rho * e for x, e in zip(u, state["e_x"])]
        else:  # adamax
            new["mu"] = [(1 - B1) * x + B1 * m for x, m in zip(g, state["mu"])]
            new["nu"] = [torch.maximum(x.abs() + EPS, B2 * v) for x, v in zip(g, state["nu"])]
            c1 = 1 - B1**count
            u = [(m / c1) / v for m, v in zip(new["mu"], new["nu"])]
        step = -lr
        return [x * step for x in u], new


def build_optimizer(
    optimizer_type: str, learning_rate: LearningRate, clip_norm: Optional[float] = 1.0
) -> Optimizer:
    """The optimizer named by the reference's ``optimizer_type`` string, with
    global-norm clipping at ``clip_norm`` (None: no clipping).
    ``learning_rate`` is a number or a schedule ``count -> rate``."""
    key = optimizer_type.lower()
    if key == "lbfgs":
        raise NotImplementedError(
            "LBFGS (optax's zoom-linesearch LBFGS) is not ported yet "
            "(ROADMAP.md Queue 1: LBFGS and Trainer.polish)"
        )
    if key not in _SLOTS:
        raise ValueError(
            f"Optimizer type {optimizer_type!r} is not recognized; "
            f"expected one of {OPTIMIZER_NAMES}"
        )
    return Optimizer(key, learning_rate, clip_norm)
