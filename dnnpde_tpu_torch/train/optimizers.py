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
- LBFGS is ``optax.lbfgs(learning_rate)`` written out (:class:`LBFGS`):
  memory 10, a scaled-identity initial preconditioner, then the zoom
  linesearch with 20 steps from a first guess of 1. It is not
  ``torch.optim.LBFGS``, whose strong-Wolfe search, first step and memory
  scaling are other algorithms. No clipping on this branch, as in JAX. Its
  linesearch stops on a data-dependent condition, so a step reads values
  back to the host and runs eagerly, never inside a CUDA graph.
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
        # grads -> their squared global norm; None sums the given tensors (a
        # tensor-parallel trainer sets one that adds the other ranks' shards)
        self.sq_norm: Optional[Callable[[Sequence[Tensor]], Tensor]] = None

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
            sq = sum(torch.sum(x * x) for x in g) if self.sq_norm is None else self.sq_norm(g)
            norm = torch.sqrt(sq)
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


def _flat(xs: Sequence[Tensor]) -> Tensor:
    return torch.cat([x.reshape(-1) for x in xs])


def _unflat(vec: Tensor, like: Sequence[Tensor]) -> list[Tensor]:
    return [v.view_as(p) for v, p in zip(torch.split(vec, [p.numel() for p in like]), like)]


def _f32(x) -> Tensor:
    """A 0-d float32 CPU tensor: the linesearch's scalars live on the host,
    in float32 as optax computes them."""
    return torch.tensor(x, dtype=torch.float32)


# optax.scale_by_zoom_linesearch's defaults, as optax.lbfgs sets them
LS_MAX_STEPS = 20
LS_INCREASE = 2.0
LS_SLOPE_RTOL = 1e-4
LS_CURV_RTOL = 0.9
LS_APPROX_DEC_RTOL = 1e-6
LS_INTERVAL_THRESHOLD = 1e-5
LS_TOL = 0.0
LBFGS_MEMORY = 10  # optax.lbfgs's memory_size


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when it has none (optax's ``_cubicmin``)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc**2 * v0 + -(db**2) * v1) / denom
    B = (-(dc**3) * v0 + db**3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo decrease error, relaxed by the approximate-decrease test of
    Hager and Zhang (optax's ``_compute_decrease_error``); NaN counts as inf."""
    err = value - value_init - LS_SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * LS_SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - LS_APPROX_DEC_RTOL * torch.abs(value_init)
    err = torch.minimum(torch.maximum(approx, delta_values), err)
    err = torch.maximum(err, _f32(0.0))
    return torch.where(torch.isnan(err), _f32(float("inf")), err)


def _curvature_error(slope, slope_init):
    err = torch.maximum(torch.abs(slope) - LS_CURV_RTOL * torch.abs(slope_init), _f32(0.0))
    return torch.where(torch.isnan(err), _f32(float("inf")), err)


def zoom_linesearch(value_and_grad: Callable, params: Tensor, direction: Tensor,
                    value: Tensor, grad: Tensor) -> Tensor:
    """The step size η of ``optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy="one")`` along ``direction`` from the flat
    ``params``, with ``value`` and ``grad`` the loss and its gradient there.

    Nocedal and Wright's algorithms 3.5 (interval search, doubling from 1)
    and 3.6 (zoom by cubic, then quadratic interpolation, else bisection),
    until the decrease and curvature errors are both 0; after 20
    evaluations, or once the interval is below 1e-5 with a safe step found,
    the best step with sufficient decrease (the last one tried when none
    has it and the values stayed finite). ``value_and_grad(flat) ->
    (value, flat grad)``. Returns η as a 0-d float32 CPU tensor."""

    def on_line(stepsize):
        v, g = value_and_grad(params + stepsize.to(params.device) * direction)
        out = torch.stack([v.reshape(()).to(torch.float32), torch.dot(g, direction)]).cpu()
        return out[0], out[1]

    value = value.detach().reshape(()).to(torch.float32).cpu()
    slope = torch.dot(direction, grad).cpu()
    zero = _f32(0.0)
    s = dict(stepsize=zero, value=value, slope=slope, decrease_error=_f32(float("inf")),
             low=zero, value_low=value, slope_low=slope, high=zero, value_high=value,
             slope_high=slope, cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero,
             safe_value=value)
    value_init, slope_init = value, slope
    interval_found = done = failed = False
    count = 0
    while not (done or failed):
        if not interval_found:  # algorithm 3.5
            new = _f32(1.0) if count == 0 else LS_INCREASE * s["stepsize"]
            v, sl = on_line(new)
            dec = _decrease_error(new, v, sl, value_init, slope_init)
            err = torch.maximum(dec, _curvature_error(sl, slope_init))
            if dec <= LS_TOL:
                s["safe_stepsize"], s["safe_value"] = new, v
            high_to_new = bool(dec > 0.0) or bool(v >= s["value"]) and count > 0
            low_to_new = bool(sl >= 0.0) and not high_to_new
            prev = (s["stepsize"], s["value"], s["slope"])
            if low_to_new:
                (s["low"], s["value_low"], s["slope_low"]), (s["high"], s["value_high"],
                                                            s["slope_high"]) = (new, v, sl), prev
            else:
                (s["low"], s["value_low"], s["slope_low"]), (s["high"], s["value_high"],
                                                            s["slope_high"]) = prev, (new, v, sl)
            s["cubic_ref"], s["value_cubic_ref"] = s["low"], s["value_low"]
            interval_found = high_to_new or low_to_new or bool(err <= LS_TOL)
            done = bool(err <= LS_TOL)
            failed = count + 1 >= LS_MAX_STEPS and not done
        else:  # algorithm 3.6
            low, high = s["low"], s["high"]
            delta = torch.abs(high - low)
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            cubic = _cubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"],
                              s["cubic_ref"], s["value_cubic_ref"])
            quad = _quadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
            if bool(cubic > left + 0.2 * delta) and bool(cubic < right - 0.2 * delta):
                new = cubic
            elif bool(quad > left + 0.1 * delta) and bool(quad < right - 0.1 * delta):
                new = quad
            else:
                new = (low + high) / 2.0
            v, sl = on_line(new)
            dec = _decrease_error(new, v, sl, value_init, slope_init)
            err = torch.maximum(dec, _curvature_error(sl, slope_init))
            if bool(dec <= LS_TOL) and bool(v < s["safe_value"]):
                s["safe_stepsize"], s["safe_value"] = new, v
            done = bool(err <= LS_TOL)
            high_to_new = bool(dec > 0.0) or bool(v >= s["value_low"])
            high_to_low = bool(sl * (high - low) >= 0.0) and not high_to_new
            old_low, old_high = ((low, s["value_low"], s["slope_low"]),
                                 (high, s["value_high"], s["slope_high"]))
            new_high = (new, v, sl) if high_to_new else old_high
            if high_to_low:
                new_high = old_low
            new_low = old_low if high_to_new else (new, v, sl)
            s["cubic_ref"], s["value_cubic_ref"] = (
                old_high[:2] if high_to_new or high_to_low else old_low[:2])
            (s["low"], s["value_low"], s["slope_low"]) = new_low
            (s["high"], s["value_high"], s["slope_high"]) = new_high
            too_small = bool(delta <= LS_INTERVAL_THRESHOLD)
            presumably = count + 1 >= LS_MAX_STEPS or (too_small and bool(s["safe_stepsize"] > 0))
            failed = presumably and not done
        s["stepsize"], s["value"], s["slope"], s["decrease_error"] = new, v, sl, dec
        count += 1
        if failed and (bool(s["safe_stepsize"] > 0.0) or bool(torch.isinf(s["decrease_error"]))):
            s["stepsize"], s["value"] = s["safe_stepsize"], s["safe_value"]
    return s["stepsize"]


class LBFGS:
    """``optax.lbfgs(learning_rate)`` (optax 0.2.6): ``scale_by_lbfgs(10,
    scale_init_precond=True)``, then ``-learning_rate`` (−1 for None), then
    :func:`zoom_linesearch`. The state is a dict of tensors on the
    parameters' device over the flattened parameters: ``count``, the last
    ``params`` and gradient, the memory of 10 (parameter, gradient)
    differences and their weights 1/(Δgᵀ Δw), and ``lr``.

    ``update(grads, state, params, value=, value_and_grad=)`` takes the loss
    at ``params`` and ``value_and_grad(list of tensors) -> (loss, grads)``,
    which the linesearch evaluates on the same batch."""

    name = "lbfgs"

    def __init__(self, learning_rate: Optional[LearningRate] = None):
        self.schedule = learning_rate if callable(learning_rate) else None
        self.learning_rate = 1.0 if learning_rate is None else learning_rate

    def init(self, params: Sequence[Tensor]) -> dict:
        flat = _flat(params).detach()
        dev, m = flat.device, LBFGS_MEMORY
        return {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "params": torch.zeros_like(flat),
            "updates": torch.zeros_like(flat),
            "diff_params": torch.zeros((m,) + flat.shape, dtype=flat.dtype, device=dev),
            "diff_updates": torch.zeros((m,) + flat.shape, dtype=flat.dtype, device=dev),
            "weights": torch.zeros((m,), dtype=torch.float32, device=dev),
            "lr": torch.tensor(0.0 if self.schedule else float(self.learning_rate),
                               dtype=torch.float32, device=dev),
        }

    def _precondition(self, g, diff_params, diff_updates, weights, gamma, memory_idx):
        """The two-loop recursion over the memory, oldest entry last in the
        first loop (optax's ``_precondition_by_lbfgs``)."""
        m = LBFGS_MEMORY
        order = [(memory_idx + i) % m for i in range(m)]
        alphas = {}
        for i in reversed(order):
            alphas[i] = weights[i] * torch.dot(diff_params[i], g)
            g = g - alphas[i] * diff_updates[i]
        g = gamma * g
        for i in order:
            beta = weights[i] * torch.dot(diff_updates[i], g)
            g = g + (alphas[i] - beta) * diff_params[i]
        return g

    def update(self, grads: Sequence[Tensor], state: dict, params: Sequence[Tensor], *,
               value: Tensor, value_and_grad: Callable):
        """(updates, new state); the inputs are not modified."""
        w, u = _flat(params).detach(), _flat(grads).detach()
        count = int(state["count"])
        m = LBFGS_MEMORY
        memory_idx, prev_idx = count % m, (count - 1) % m
        first = count == 0
        dp = torch.zeros_like(w) if first else w - state["params"]
        du = torch.zeros_like(u) if first else u - state["updates"]
        vdot = torch.dot(du, dp)
        weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
        diff_params = state["diff_params"].clone()
        diff_updates = state["diff_updates"].clone()
        weights = state["weights"].clone()
        diff_params[prev_idx] = dp
        diff_updates[prev_idx] = du
        weights[prev_idx] = weight
        if first:  # a capped reciprocal of the gradient norm
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(u), max=1.0)
        else:
            den = torch.dot(du, du)
            gamma = torch.where(den > 0.0, vdot / den, torch.ones_like(den))
        direction = self._precondition(u, diff_params, diff_updates, weights, gamma, memory_idx)
        lr = (torch.as_tensor(self.schedule(state["count"]), dtype=torch.float32,
                              device=w.device) if self.schedule else state["lr"])
        direction = -lr * direction

        def flat_value_and_grad(flat):
            v, g = value_and_grad(_unflat(flat, params))
            return v, _flat(g).detach()

        eta = zoom_linesearch(flat_value_and_grad, w, direction, value, u)
        new = {"count": state["count"] + 1, "params": w, "updates": u,
               "diff_params": diff_params, "diff_updates": diff_updates, "weights": weights,
               "lr": lr}
        return _unflat(eta.to(w.device) * direction, params), new


def build_optimizer(
    optimizer_type: str, learning_rate: LearningRate, clip_norm: Optional[float] = 1.0
):
    """The optimizer named by the reference's ``optimizer_type`` string, with
    global-norm clipping at ``clip_norm`` (None: no clipping; LBFGS never
    clips). ``learning_rate`` is a number or a schedule ``count -> rate``
    (None for LBFGS: its linesearch's step sizes unscaled)."""
    key = optimizer_type.lower()
    if key == "lbfgs":
        return LBFGS(learning_rate)
    if key not in _SLOTS:
        raise ValueError(
            f"Optimizer type {optimizer_type!r} is not recognized; "
            f"expected one of {OPTIMIZER_NAMES}"
        )
    return Optimizer(key, learning_rate, clip_norm)
