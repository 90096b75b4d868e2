"""Deep-BSDE objective of the PyTorch port: rollout + BSDE residual + terminal
penalties (global objective), the counterpart of ``dnnpde_tpu/solver/bsde.py``.

The JAX package runs the rollout as one ``lax.scan``; here it is a Python
loop over the N steps, since PyTorch runs eagerly. The rest follows the
reference:

- Z = ∇ₓu comes with every net evaluation (``make_net_u`` by autograd, or
  the fused path of ``ops/fused_net_u.py``).
- Increments, not cumulated paths, are the input: ``dWs`` (N, M, D).
- The loop carry is slim, (t, X, Ỹ): the net is evaluated at the START of
  each step and the BSDE one-step prediction Ỹ rides the carry.
- Step 0 is peeled out of the loop, so Y0 comes from that evaluation.

Loss (reference semantics, summed — not averaged — over the batch):
  Σ_n Σ_m (Y_{n+1} − Ỹ_{n+1})²  +  Σ_m (Y_N − g(X_N))²  +  Σ_m ‖(Z_N − Dg(X_N))·mask‖²
where Ỹ_{n+1} = Y_n + φ(t,X,Y,Z)·Δt + Zᵀσ(t,X,Y)ΔW.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from dnnpde_tpu_torch.pde.base import PDEProblem

Tensor = torch.Tensor

_LATER = "is not ported yet (ROADMAP.md Queue 1, item 1: the deep-BSDE loss beyond the global objective)"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver knobs, with the JAX package's fields and defaults.

    remat: recompute each rollout step in the backward pass
      (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
      activations, as ``jax.checkpoint`` does for the scan body.
    fused_net_u: False = (u, Z) by autograd of the net (``make_net_u``);
      True or "torch" = the fused f32 ``mlp_u_z`` (sine/tanh/relu),
      differentiated by autograd; "cuda" = the fused kernel pair K1 + K2
      (sine; ``ops/fused_net_u.py::FusedMlpUZ``), the counterpart of JAX's
      "pallas". Plain MLPs without an output transform only.

    The other fields exist for parity with the JAX config; any value but
    their default raises ``NotImplementedError`` in :func:`make_loss_fn`.
    """

    remat: bool = True
    stochastic_net: bool = False
    unroll: int = 1
    remat_policy: Optional[str] = None
    fused_net_u: bool | str = False
    objective: str = "global"
    path_weight_fn: Optional[Callable] = None
    z_match_weight: float = 0.0
    z_match_mask: Optional[tuple] = None


class RolloutResult(NamedTuple):
    """Mirrors the reference loss_function returns: (loss, X, Y, Y0)."""

    loss: Tensor  # scalar
    X: Tensor  # (M, N+1, D)
    Y: Tensor  # (M, N+1, 1)
    Y0: Tensor  # scalar — Y[0, 0, 0]


def make_net_u(net: torch.nn.Module, transform: Optional[Callable] = None) -> Callable:
    """Build net_u(t, X) → (u, Z) for ``net`` with Z = ∇ₓu by one
    ``torch.autograd.grad`` of Σu.

    ``transform`` ``(t, X, raw) → u`` is the problem's output
    parametrization (pass ``problem.transform_u``); it is applied before
    differentiation, so Z sees its gradient. None is the identity.

    When grad mode is on, Z keeps its graph (``create_graph``) so a loss on Z
    can be differentiated; otherwise u and Z come back detached. Stochastic
    nets are not ported yet.
    """

    def net_u(t: Tensor, X: Tensor):
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            x = X if X.requires_grad else X.detach().requires_grad_(True)
            u = net(torch.cat([t, x], dim=-1))
            if transform is not None:
                u = transform(t, x, u)
            (Z,) = torch.autograd.grad(u.sum(), x, create_graph=create_graph)
        if not create_graph:
            u = u.detach()
        return u, Z

    return net_u


def _terminal_penalty(problem: PDEProblem, X_N: Tensor, Y_N: Tensor, Z_N: Tensor) -> Tensor:
    """(Y_N − g)² + ‖(Z_N − Dg)·mask‖² summed over the batch."""
    dy2 = (Y_N - problem.g(X_N)) ** 2
    dz = Z_N - problem.Dg(X_N)
    mask = problem.z_penalty_mask
    if mask is not None:
        dz = dz * mask
    dz2 = torch.sum(dz**2, dim=-1, keepdim=True)
    return torch.sum(dy2) + torch.sum(dz2)


def _check_config(problem: PDEProblem, config: SolverConfig) -> None:
    if config.objective not in ("global", "local"):
        raise ValueError(f"objective must be 'global' or 'local', got {config.objective!r}")
    later = {
        "objective='local'": config.objective == "local",
        "z_match_weight": bool(config.z_match_weight) or config.z_match_mask is not None,
        "path_weight_fn": config.path_weight_fn is not None,
        "stochastic_net": config.stochastic_net,
        "remat_policy": config.remat_policy is not None,
        "unroll": config.unroll != 1,
        "early exercise": problem.early_exercise,
    }
    for name, used in later.items():
        if used:
            raise NotImplementedError(f"{name} {_LATER}")


def _bind_net_u(problem: PDEProblem, net, config: SolverConfig) -> Callable:
    """module → net_u(t, X) for one loss evaluation. The fused path extracts
    the weights once here, not at each of the N+1 evaluations."""
    if not config.fused_net_u:
        return lambda module: make_net_u(module, transform=problem.transform_u)
    from dnnpde_tpu_torch.ops.fused_net_u import check_fused, fused_u_z
    from dnnpde_tpu_torch.params import extract_mlp_params

    if problem.has_output_transform:
        raise ValueError("fused_net_u supports plain MLPs without output transform")
    backend = "torch" if config.fused_net_u is True else str(config.fused_net_u)
    act = check_fused(net.activation, backend)
    n_dense = len(net.layers) - 1

    def bind(module):
        Ws, bs = extract_mlp_params(module)
        if len(Ws) != n_dense:
            raise ValueError(f"net has {len(Ws)} layers, expected {n_dense}")
        return functools.partial(fused_u_z, Ws, bs, act=act, backend=backend)

    return bind


def make_loss_fn(
    problem: PDEProblem,
    net: torch.nn.Module,
    config: SolverConfig = SolverConfig(),
) -> Callable:
    """Build loss(net, ts, dWs, X0) → RolloutResult.

    ``net`` here gives the structure (``layers``, ``activation``); the
    returned function evaluates the module it is given (the JAX loss takes
    the parameter tree instead). Args of the returned function:
      ts:  (N+1, M, 1) time-major time grid (ts[0] is the start time).
      dWs: (N, M, D) time-major Brownian increments.
      X0:  (M, D) initial states.
    """
    _check_config(problem, config)
    bind = _bind_net_u(problem, net, config)

    def em_step(t0, X0, Y0, Z0, t1, dW):
        """Euler–Maruyama X-step + BSDE Ỹ-step from a known (Y, Z) at t0."""
        dt = t1 - t0
        sdw = problem.sigma_dw(problem.sigma(t0, X0, Y0), dW)
        X1 = X0 + problem.mu(t0, X0, Y0, Z0) * dt + sdw
        if problem.has_post_step:
            X1 = problem.post_step(t1, X1)
        Y1_tilde = (
            Y0 + problem.phi(t0, X0, Y0, Z0) * dt + torch.sum(Z0 * sdw, dim=-1, keepdim=True)
        )
        return X1, Y1_tilde

    def step(net_u, t0, X0, Ytilde0, t1, dW):
        """One rollout step from the slim carry: the residual of the net's
        value at t0 against the carried prediction, then the next carry."""
        Y0, Z0 = net_u(t0, X0)
        residual = torch.sum((Y0 - Ytilde0) ** 2)
        X1, Y1_tilde = em_step(t0, X0, Y0, Z0, t1, dW)
        return X1, Y1_tilde, residual, Y0

    def loss_fn(module: torch.nn.Module, ts: Tensor, dWs: Tensor, X0: Tensor) -> RolloutResult:
        net_u = bind(module)
        body = functools.partial(step, net_u)
        if config.remat:
            body = functools.partial(checkpoint, body, use_reentrant=False)
        # step 0, peeled: Y0 comes from this evaluation
        Y0, Z0 = net_u(ts[0], X0)
        X, Ytilde = em_step(ts[0], X0, Y0, Z0, ts[1], dWs[0])
        Xs, Ys, residuals = [X0, X], [Y0], []
        for n in range(1, dWs.shape[0]):
            X, Ytilde, residual, Yn = body(ts[n], X, Ytilde, ts[n + 1], dWs[n])
            Xs.append(X)
            Ys.append(Yn)
            residuals.append(residual)
        # the final evaluation closes the rollout: last residual + terminal penalties
        YN, ZN = net_u(ts[-1], X)
        Ys.append(YN)
        loss = torch.sum((YN - Ytilde) ** 2)
        if residuals:
            loss = torch.stack(residuals).sum() + loss
        loss = loss + _terminal_penalty(problem, X, YN, ZN)
        Y = torch.stack(Ys, dim=1)
        return RolloutResult(loss, torch.stack(Xs, dim=1), Y, Y[0, 0, 0])

    return loss_fn


def make_path_loss_fn(
    problem: PDEProblem,
    net: torch.nn.Module,
    config: SolverConfig = SolverConfig(),
) -> Callable:
    """Reference-shaped API: loss(net, t, W, Xi) with t (M, N+1, 1),
    W (M, N+1, D), Xi (1, D) or (M, D)."""
    loss_fn = make_loss_fn(problem, net, config)

    def path_loss(module, t: Tensor, W: Tensor, Xi) -> RolloutResult:
        M = t.shape[0]
        Xi = torch.as_tensor(Xi, dtype=torch.float32, device=t.device).reshape(-1, problem.dim)
        X0 = Xi.expand(M, problem.dim) if Xi.shape[0] == 1 else Xi
        ts = t.transpose(0, 1)
        dWs = torch.diff(W, dim=1).transpose(0, 1)
        return loss_fn(module, ts, dWs, X0)

    return path_loss
