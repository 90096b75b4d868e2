"""Save and load a learned solution ``(t, X) → (u, Z = ∇ₓu)``, the
counterpart of ``dnnpde_tpu/serve/export.py``.

The artifact is a ``torch.save`` file of plain data: the net's mode, widths,
activation and weights, the state dimension and, when the solution has an
output transform, the problem's class name and dataclass fields, from which
``load_solution`` rebuilds the problem. It is not a StableHLO program:
loading it needs this package.

``ServedSolution`` computes u in f32 and Z by one reverse pass through
``transform_u ∘ net``, as the JAX package's ``_solution_fn`` serves them.
An FC net without a transform takes the fused f32 ``mlp_u_z`` (its weights
in the JAX layout, ``Ws``/``bs``); kernel K1 (bf16 dot operands) serves
``Trainer.predict`` under ``SolverConfig(fused_net_u="cuda")``, as the
Pallas K1 does in JAX. A stochastic net (``SDENet``) is served under the
fixed noise of the evaluation paths, as JAX serves it with a fixed key: the
served (u, Z) are ``Trainer.evaluate_u``'s, and repeat from call to call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from dnnpde_tpu_torch.nets.networks import (
    MLP,
    NaisNet,
    ResNet,
    SDENet,
    VerletNet,
    build_network,
)
from dnnpde_tpu_torch.ops.fused_net_u import _ACT_DERIVS, mlp_u_z
from dnnpde_tpu_torch.params import extract_mlp_params
from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.runtime import default_device
from dnnpde_tpu_torch.solver.bsde import make_net_u

Tensor = torch.Tensor

_NET_MODES = {MLP: "FC", NaisNet: "Naisnet", ResNet: "Resnet", VerletNet: "Verlet",
              SDENet: "SDEnet"}


def _problem_classes() -> dict:
    from dnnpde_tpu_torch import pde

    return {name: getattr(pde, name) for name in pde.__all__ if name != "PDEProblem"}


def _problem_record(transform) -> Optional[dict]:
    """The problem behind ``transform`` (a bound ``problem.transform_u``) as
    plain data: class name and dataclass fields."""
    if transform is None:
        return None
    problem = getattr(transform, "__self__", None)
    if not isinstance(problem, PDEProblem) or getattr(transform, "__name__", "") != "transform_u":
        raise ValueError(
            "transform must be a problem's bound transform_u (the artifact stores the problem)"
        )
    name = type(problem).__name__
    if _problem_classes().get(name) is not type(problem):
        raise ValueError(f"cannot store a {name}: not a problem class of dnnpde_tpu_torch.pde")
    return {"class": name, "fields": {f.name: getattr(problem, f.name)
                                      for f in dataclasses.fields(problem)}}


def export_solution(net: torch.nn.Module, dim: int, transform=None) -> dict:
    """The artifact of ``net``'s solution for a ``dim``-dimensional state, as
    plain data. ``transform``: the problem's ``transform_u`` (its problem is
    stored), or None. An SDENet's ``h``, ``eps`` and ``deterministic`` are
    stored with its weights."""
    mode = _NET_MODES.get(type(net))
    if mode is None:
        raise NotImplementedError(f"cannot serve a {type(net).__name__}")
    act = str(net.activation).lower()
    if act not in _ACT_DERIVS:
        raise ValueError(f"cannot serve activation {net.activation!r}")
    if net.layers[0] != dim + 1 or net.layers[-1] != 1:
        raise ValueError(f"net layers {net.layers} do not map [t, X] ({dim + 1}) to u (1)")
    blob: dict[str, Any] = {
        "mode": mode, "layers": list(net.layers), "activation": act, "dim": int(dim),
        "problem": _problem_record(transform),
    }
    if mode == "FC":
        Ws, bs = extract_mlp_params(net)
        blob["Ws"] = [w.detach().cpu() for w in Ws]
        blob["bs"] = [b.detach().cpu() for b in bs]
    else:
        blob["state"] = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    if mode == "SDEnet":
        blob["net_kwargs"] = {"h": net.h, "eps": net.eps, "deterministic": net.deterministic}
    return blob


def export_trainer(trainer, use_ema: bool = False) -> dict:
    """The artifact of a :class:`~dnnpde_tpu_torch.train.Trainer`'s current
    solution; ``use_ema=True`` stores the EMA shadow (needs ``ema_decay``)."""
    problem = trainer.problem
    return export_solution(
        trainer.ema_params if use_ema else trainer.params, problem.dim,
        transform=problem.transform_u if problem.has_output_transform else None,
    )


def save_solution(path: str, *args, **kwargs) -> None:
    """:func:`export_solution` (or, given a Trainer, :func:`export_trainer`)
    to a file: ``save_solution(path, net, dim, transform=...)`` or
    ``save_solution(path, trainer, use_ema=...)``."""
    if args and hasattr(args[0], "problem"):  # a Trainer
        blob = export_trainer(*args, **kwargs)
    else:
        blob = export_solution(*args, **kwargs)
    torch.save(blob, path)


@dataclasses.dataclass(frozen=True)
class ServedSolution:
    """A loaded solution: u and ∇ₓu at any (t, X) batch on ``device``.

    ``Ws``/``bs`` hold an FC net's weights in the JAX layout; ``net`` holds
    any other net, and ``problem`` the output transform's problem."""

    layers: tuple[int, ...]
    activation: str
    dim: int
    Ws: tuple[Tensor, ...]
    bs: tuple[Tensor, ...]
    device: torch.device
    mode: str = "FC"
    net: Optional[torch.nn.Module] = None
    problem: Optional[PDEProblem] = None

    def u_and_grad(self, t, X) -> tuple[np.ndarray, np.ndarray]:
        """(u (b,1), Z (b,D)) as host numpy: t (b, 1) or scalar-broadcastable,
        X (b, D)."""
        u, Z = self.u_and_grad_device(t, X)
        return u.cpu().numpy(), Z.cpu().numpy()

    def u_and_grad_device(self, t, X) -> tuple[Tensor, Tensor]:
        """(u, Z) as tensors on the device, without a host sync."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device).reshape(-1, self.dim)
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device).reshape(-1, 1)
        t = t.expand(X.shape[0], 1)
        if self.net is None and self.problem is None:
            u, z_full = mlp_u_z(self.Ws, self.bs, torch.cat([t, X], dim=1), self.activation)
            return u, z_full[:, 1:]
        with torch.no_grad():
            return make_net_u(self.net, self.problem.transform_u if self.problem else None)(t, X)

    def u(self, t, X) -> np.ndarray:
        return self.u_and_grad(t, X)[0]

    def surface(self, t_values, x_points) -> np.ndarray:
        """u on the (t, x) product grid: t_values (nt,), x_points (nx, D)
        → (nt, nx), in one batched call."""
        t_values = np.asarray(t_values, np.float32).reshape(-1)
        x_points = np.asarray(x_points, np.float32).reshape(-1, self.dim)
        nt, nx = len(t_values), len(x_points)
        t = np.repeat(t_values, nx)[:, None]
        X = np.tile(x_points, (nt, 1))
        u, _ = self.u_and_grad(t, X)
        return u.reshape(nt, nx)


def load_solution(path: str, device=None) -> ServedSolution:
    """Load a solution written by :func:`save_solution` onto ``device``
    (None: the first CUDA card)."""
    device = default_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    mode = blob.get("mode", "FC")
    record = blob.get("problem")
    problem = None
    if record is not None:
        problem = _problem_classes()[record["class"]](**record["fields"])
    Ws = tuple(w.to(device).contiguous() for w in blob.get("Ws", ()))
    bs = tuple(b.to(device).contiguous() for b in blob.get("bs", ()))
    net = None
    init = dict(generator=torch.Generator(), device=device)  # overwritten below
    if mode == "FC" and problem is not None:
        net = MLP(blob["layers"], blob["activation"], **init)
        with torch.no_grad():
            for layer, w, b in zip(net.dense, Ws, bs):
                layer.linear.weight.copy_(w.t())
                layer.linear.bias.copy_(b)
    elif mode != "FC":
        net = build_network(mode, blob["layers"], blob["activation"], **init,
                            **blob.get("net_kwargs", {}))
        net.load_state_dict(blob["state"])
    if net is not None:
        net.requires_grad_(False)
    return ServedSolution(
        layers=tuple(blob["layers"]), activation=blob["activation"], dim=int(blob["dim"]),
        Ws=Ws, bs=bs, device=device, mode=mode, net=net, problem=problem,
    )
