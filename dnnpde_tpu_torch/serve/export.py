"""Save and load a learned solution ``(t, X) → (u, Z = ∇ₓu)``.

The artifact is a ``torch.save`` file of the weights in the JAX layout plus
what is needed to evaluate them (``layers``, ``activation``, ``dim``). It is
not a StableHLO program: loading it needs this package. ``ServedSolution``
computes (u, Z) in f32 with the fused ``mlp_u_z`` for every activation, as
the JAX package's ``_solution_fn`` serves u in f32 and Z by one VJP; kernel
K1 (bf16 dot operands) serves ``Trainer.predict`` under
``SolverConfig(fused_net_u="cuda")``, as the Pallas K1 does in JAX. Output
transforms and stochastic nets are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dnnpde_tpu_torch.nets.networks import MLP
from dnnpde_tpu_torch.ops.fused_net_u import _ACT_DERIVS, mlp_u_z
from dnnpde_tpu_torch.params import extract_mlp_params
from dnnpde_tpu_torch.runtime import default_device

Tensor = torch.Tensor


def save_solution(path: str, net: MLP, dim: int, transform=None, stochastic: bool = False) -> None:
    """Write ``net``'s solution for a ``dim``-dimensional state to ``path``."""
    if transform is not None or stochastic:
        raise NotImplementedError(
            "serving output transforms and stochastic nets is not ported yet"
        )
    if not isinstance(net, MLP):
        raise NotImplementedError(f"serving supports the FC MLP only, got {type(net).__name__}")
    act = str(net.activation).lower()
    if act not in _ACT_DERIVS:
        raise ValueError(f"cannot serve activation {net.activation!r}")
    if net.layers[0] != dim + 1 or net.layers[-1] != 1:
        raise ValueError(f"net layers {net.layers} do not map [t, X] ({dim + 1}) to u (1)")
    Ws, bs = extract_mlp_params(net)
    torch.save(
        {
            "layers": list(net.layers),
            "activation": act,
            "dim": int(dim),
            "Ws": [w.detach().cpu() for w in Ws],
            "bs": [b.detach().cpu() for b in bs],
        },
        path,
    )


@dataclasses.dataclass(frozen=True)
class ServedSolution:
    """A loaded solution: u and ∇ₓu at any (t, X) batch on ``device``."""

    layers: tuple[int, ...]
    activation: str
    dim: int
    Ws: tuple[Tensor, ...]
    bs: tuple[Tensor, ...]
    device: torch.device

    def u_and_grad(self, t, X) -> tuple[np.ndarray, np.ndarray]:
        """(u (b,1), Z (b,D)) as host numpy: t (b, 1) or scalar-broadcastable,
        X (b, D)."""
        u, Z = self.u_and_grad_device(t, X)
        return u.cpu().numpy(), Z.cpu().numpy()

    def u_and_grad_device(self, t, X) -> tuple[Tensor, Tensor]:
        """(u, Z) as tensors on the device, without a host sync."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device).reshape(-1, self.dim)
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device).reshape(-1, 1)
        x = torch.cat([t.expand(X.shape[0], 1), X], dim=1)
        u, z_full = mlp_u_z(self.Ws, self.bs, x, self.activation)
        return u, z_full[:, 1:]

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
    return ServedSolution(
        layers=tuple(blob["layers"]),
        activation=blob["activation"],
        dim=int(blob["dim"]),
        Ws=tuple(w.to(device).contiguous() for w in blob["Ws"]),
        bs=tuple(b.to(device).contiguous() for b in blob["bs"]),
        device=device,
    )
