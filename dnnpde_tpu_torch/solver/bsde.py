"""Deep-BSDE objective of the PyTorch port: rollout + BSDE residuals +
terminal penalties, the counterpart of ``dnnpde_tpu/solver/bsde.py``.

The JAX package runs the rollout as one ``lax.scan``; here it is a Python
loop over the N steps, since PyTorch runs eagerly. The rest follows the
reference:

- Z = ∇ₓu comes with every net evaluation (``make_net_u`` by autograd, or
  the fused path of ``ops/fused_net_u.py``).
- Increments, not cumulated paths, are the input: ``dWs`` (N, M, D).
- The loop carry is slim, (t, X, Ỹ): the net is evaluated at the START of
  each step and the BSDE one-step prediction Ỹ rides the carry. Under
  Z-matching it widens by the previous step's (σᵀZ, base, ΔW, Δt).
- Step 0 is peeled out of the loop, so Y0 comes from that evaluation.

Loss of the global objective (reference semantics, summed — not averaged —
over the batch):
  Σ_n Σ_m (Y_{n+1} − Ỹ_{n+1})²  +  Σ_m (Y_N − g(X_N))²  +  Σ_m ‖(Z_N − Dg(X_N))·mask‖²
where Ỹ_{n+1} = Y_n + φ(t,X,Y,Z)·Δt + Zᵀσ(t,X,Y)ΔW. The local objective
regresses each Ỹ_{n+1} onto a detached target instead: u(t_{n+1}, X_{n+1})
of the same parameters (or of ``target_params``), clamped at the payoff on
the exercise dates of an early-exercise problem, and g(X_N) at the last
step (see :class:`SolverConfig`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from dnnpde_tpu_torch.pde.base import PDEProblem
from dnnpde_tpu_torch.runtime import OnDevice
from dnnpde_tpu_torch.solver.remat import policy_contexts, resolve_policy

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver knobs, with the JAX package's fields and defaults.

    remat: recompute each rollout step in the backward pass
      (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
      activations, as ``jax.checkpoint`` does for the scan body.
    remat_policy: read only when ``remat`` is on, as in JAX: a name of
      ``jax.checkpoint_policies``' plain policies, whose step outputs the
      forward pass keeps for the recompute (``solver/remat.py``): None or
      "nothing_saveable" = full remat; "everything_saveable"; "dots_saveable"
      or "checkpoint_dots" = the outputs of ``mm``, ``addmm`` and ``bmm``,
      recomputing the elementwise chain; "dots_with_no_batch_dims_saveable"
      or "checkpoint_dots_with_no_batch_dims" = those of 2-D products only.
      JAX's factory policies need arguments this config cannot carry, and
      their names raise ``ValueError``. A policy changes no number.
    unroll: ``lax.scan``'s unroll factor (an int ≥ 1, or a bool), accepted
      for parity. The rollout here is a Python loop, and a training
      iteration captured into a CUDA graph replays it fully unrolled, so
      the value changes nothing; a non-positive int raises ``ValueError``.
    fused_net_u: False = (u, Z) by autograd of the net (``make_net_u``);
      True or "torch" = the fused f32 ``mlp_u_z`` (sine/tanh/relu),
      differentiated by autograd; "cuda" = the fused kernel pair K1 + K2
      (sine; ``ops/fused_net_u.py::FusedMlpUZ``), the counterpart of JAX's
      "pallas". Plain MLPs, and NAIS-Nets with at least one block
      (``FusedNaisUZ``; the blocks' projections computed once per loss),
      without an output transform only.
    objective: "global" (the reference's summed residual, gradients through
      both sides of every residual) or "local" (backward induction: each
      one-step prediction Ỹ_{n+1} regresses onto a detached target,
      u(t_{n+1}, X_{n+1}) of the same parameters, or of the loss's
      ``target_params``, and the payoff g(X_N) at the last step; early-
      exercise problems clamp the target at the payoff on their exercise
      dates, the Snell recursion, and require "local").
    path_weight_fn: ``X0 -> (M,) or (M, 1)`` weights multiplying each
      path's share of every residual and of both terminal penalties, used
      as given (keep their mean near 1).
    z_match_weight: λ of the Z-matching term of the local objective: each
      step adds λ·Δt·Σ_j mask_j ((σᵀZ_θ)_j − C̃_j)² with
      C̃_j = B·ΔW_j/Δt − corr_j, B = tgt_{n+1} − (tgt_n + φΔt) (detached)
      and the zero-mean control corr_j = (sg[σᵀZ]·ΔW)·ΔW_j/Δt − sg[(σᵀZ)_j];
      the JAX config's comments give the derivation.
    z_match_mask: per-Brownian-component weights of that term (None = 1).
    stochastic_net: the net draws noise at every evaluation (``SDENet``):
      the loss draws one evaluation's noise (``net.draw_noise``) before each
      of the N + 1 evaluations, in order, from the ``noise`` callable it is
      given; the local objective's target at a step sees that step's noise.
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
    X: Optional[Tensor]  # (M, N+1, D); None when the loss was asked for no paths
    Y: Optional[Tensor]  # (M, N+1, 1); likewise
    Y0: Tensor  # scalar — Y[0, 0, 0]


def make_net_u(net: torch.nn.Module, transform: Optional[Callable] = None) -> Callable:
    """Build net_u(t, X, noise=None) → (u, Z) for ``net`` with Z = ∇ₓu by
    one ``torch.autograd.grad`` of Σu.

    ``transform`` ``(t, X, raw) → u`` is the problem's output
    parametrization (pass ``problem.transform_u``); it is applied before
    differentiation, so Z sees its gradient. None is the identity.

    When grad mode is on, Z keeps its graph (``create_graph``) so a loss on Z
    can be differentiated; otherwise u and Z come back detached. ``noise``
    is a stochastic net's per-block noise (``SDENet.draw_noise``); None
    evaluates it under the fixed noise of the evaluation paths.
    """

    def net_u(t: Tensor, X: Tensor, noise=None):
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            x = X if X.requires_grad else X.detach().requires_grad_(True)
            inp = torch.cat([t, x], dim=-1)
            u = net(inp) if noise is None else net(inp, noise)
            if transform is not None:
                u = transform(t, x, u)
            (Z,) = torch.autograd.grad(u.sum(), x, create_graph=create_graph)
        if not create_graph:
            u = u.detach()
        return u, Z

    return net_u


def make_functional_net_u(module, transform: Optional[Callable] = None) -> Callable:
    """:func:`make_net_u` for a loss evaluated under ``torch.func``
    transforms (``vmap`` over replicas of ``grad``): Z = ∇ₓΣu by
    ``torch.func.vjp``, which composes with the enclosing transforms, where
    ``torch.autograd.grad`` on an input marked ``requires_grad_`` is not
    allowed. Z keeps its dependence on the parameters for the outer
    ``grad``."""

    def net_u(t: Tensor, X: Tensor, noise=None):
        def u_of(x):
            inp = torch.cat([t, x], dim=-1)
            u = module(inp) if noise is None else module(inp, noise)
            return u if transform is None else transform(t, x, u)

        u, vjp = torch.func.vjp(u_of, X)
        (Z,) = vjp(torch.ones_like(u))
        return u, Z

    return net_u


def _functional_dg(problem: PDEProblem) -> Callable:
    """X → ∇ₓΣg by ``torch.func.vjp``: ``problem.Dg`` for a loss under
    ``torch.func`` transforms."""

    def dg(X: Tensor) -> Tensor:
        g, vjp = torch.func.vjp(problem.g, X)
        (grad,) = vjp(torch.ones_like(g))
        return grad

    return dg


def _terminal_penalty(problem: PDEProblem, X_N: Tensor, Y_N: Tensor, Z_N: Tensor,
                      mask: Optional[Tensor] = None, w: Optional[Tensor] = None,
                      dg: Optional[Callable] = None) -> Tensor:
    """(Y_N − g)² + ‖(Z_N − Dg)·mask‖² summed over the batch; ``mask`` is
    ``problem.z_penalty_mask`` on X_N's device, ``w`` optional (M, 1) path
    weights, ``dg`` the gradient of g (default ``problem.Dg``)."""
    dy2 = (Y_N - problem.g(X_N)) ** 2
    dz = Z_N - (problem.Dg if dg is None else dg)(X_N)
    if mask is not None:
        dz = dz * mask
    dz2 = torch.sum(dz**2, dim=-1, keepdim=True)
    if w is not None:
        dy2 = w * dy2
        dz2 = w * dz2
    return torch.sum(dy2) + torch.sum(dz2)


def _check_config(problem: PDEProblem, config: SolverConfig) -> None:
    """The JAX package's config errors."""
    if config.objective not in ("global", "local"):
        raise ValueError(f"objective must be 'global' or 'local', got {config.objective!r}")
    local = config.objective == "local"
    if float(config.z_match_weight or 0.0) and not local:
        raise ValueError(
            "z_match_weight requires objective='local': the z-matching "
            "regression target is the detached per-step local target"
        )
    if problem.early_exercise and not local:
        raise ValueError(
            "early_exercise problems require objective='local': the "
            "reflected-BSDE recursion V_k = max(g, E_k[V_{k+1}] - phi*dt) "
            "clamps the per-step regression target at the payoff, and the "
            "global summed-residual rollout has no per-step target to clamp"
        )
    unroll = config.unroll
    if not isinstance(unroll, bool) and (not isinstance(unroll, int) or unroll < 1):
        raise ValueError(f"unroll must be an int >= 1 or a bool, got {unroll!r}")


def _bind_net_u(problem: PDEProblem, net, config: SolverConfig,
                functional: bool = False) -> Callable:
    """module → net_u(t, X, noise=None) for one loss evaluation. The fused path extracts
    the weights once here, not at each of the N+1 evaluations (a NAIS-Net's
    projections too, under the span ``dnnpde.nets.nais_project``)."""
    if functional:
        if config.fused_net_u or config.remat:
            raise ValueError(
                "a loss under torch.func transforms takes (u, Z) by autograd of the net "
                "(fused_net_u=False) without remat")
        return lambda module: make_functional_net_u(module, transform=problem.transform_u)
    if not config.fused_net_u:
        return lambda module: make_net_u(module, transform=problem.transform_u)
    from dnnpde_tpu_torch import tracing
    from dnnpde_tpu_torch.nets.networks import MLP, ResNet
    from dnnpde_tpu_torch.ops.fused_net_u import check_fused, fused_u_z
    from dnnpde_tpu_torch.params import extract_mlp_params, extract_nais_params

    nais = isinstance(net, ResNet) and net.stable and len(net.blocks) > 0
    if problem.has_output_transform or config.stochastic_net or not (
            isinstance(net, MLP) or nais):
        raise ValueError("fused_net_u supports plain MLPs and NAIS-Nets with at least one "
                         "block, without output transform")
    backend = "torch" if config.fused_net_u is True else str(config.fused_net_u)
    act = check_fused(net.activation, backend)
    n_dense = len(net.layers) - 1

    def weights(module):
        if not nais:
            return extract_mlp_params(module)
        with tracing.span("dnnpde.nets.nais_project"):
            return extract_nais_params(module)

    def bind(module):
        Ws, bs = weights(module)
        if len(Ws) != n_dense:
            raise ValueError(f"net has {len(Ws)} layers, expected {n_dense}")
        fused = functools.partial(fused_u_z, Ws, bs, act=act, backend=backend, nais=nais)
        return lambda t, X, noise=None: fused(t, X)  # a fused net takes no noise

    return bind


def make_loss_fn(
    problem: PDEProblem,
    net: torch.nn.Module,
    config: SolverConfig = SolverConfig(),
    functional: bool = False,
) -> Callable:
    """Build loss(net, ts, dWs, X0, paths=True, target_params=None,
    noise=None, weights=None) → RolloutResult.

    ``functional=True`` builds the loss for evaluation under ``torch.func``
    transforms (the replica programs of ``train/replicas.py`` vmap its
    ``grad`` over stacked weights): Z comes from
    :func:`make_functional_net_u`, and the config must use neither the fused
    net_u nor remat.

    ``net`` here gives the structure (``layers``, ``activation``); the
    returned function evaluates the module it is given (the JAX loss takes
    the parameter tree instead). Args of the returned function:
      ts:  (N+1, M, 1) time-major time grid (ts[0] is the start time).
      dWs: (N, M, D) time-major Brownian increments.
      X0:  (M, D) initial states.
      paths: stack the rollout's X and Y into the result. Training reads
        only the loss and Y0 (the JAX Trainer leaves the stacking to XLA's
        dead-code elimination), so it passes False and gets X = Y = None;
        the loss and its gradients are the same either way.
      target_params: a module of the net's structure whose u (through
        ``problem.transform_u``, no Z) gives the local objective's targets
        in place of the trained net's own (e.g. the Trainer's EMA shadow
        under ``objective="local_ema"``); it gets no gradient.
      noise: with ``config.stochastic_net``, ``noise(shape)`` → U[0, 1) of
        that shape on the batch's device (the Trainer's draws from its
        generator); None draws from a fresh generator seeded 0 (JAX's
        default ``PRNGKey(0)``). Ignored otherwise.
      weights: the rows' path weights, (M,) or (M, 1), in place of
        ``config.path_weight_fn(X0)`` (a data-parallel rank's share of the
        weights of the whole batch, whose normalization is global).
    """
    _check_config(problem, config)
    # JAX reads the policy only under remat; an unsupported name raises here
    save_rule = resolve_policy(config.remat_policy) if config.remat else None
    bind = _bind_net_u(problem, net, config, functional)
    dg = _functional_dg(problem) if functional else None
    local = config.objective == "local"
    early = problem.early_exercise
    zmatch = float(config.z_match_weight or 0.0)
    z_penalty_mask = OnDevice(problem.z_penalty_mask)
    z_match_mask = OnDevice(
        None if config.z_match_mask is None
        else torch.tensor(config.z_match_mask, dtype=torch.float32))

    stochastic = config.stochastic_net

    def u_target(target, t, X, eps):
        """u-only evaluation under the target parameters, detached, under
        the step's noise ``eps``."""
        inp = torch.cat([t, X], dim=-1)
        with torch.no_grad():
            return problem.transform_u(t, X, target(inp) if eps is None else target(inp, eps))

    def path_weights(X0, weights):
        if weights is None:
            if config.path_weight_fn is None:
                return None
            weights = config.path_weight_fn(X0)
        return torch.as_tensor(weights).reshape(X0.shape[0], 1)

    def weighted_sum(vec, w):
        """Σ_m w_m · vec_m for a per-path (M, 1) vector."""
        return torch.sum(vec if w is None else w * vec)

    def z_proj(t0, X0, Y0, Z0):
        """(σᵀZ)_j, the net side of the Z-matching regression."""
        sig = problem.sigma(t0, X0, Y0)
        if problem.sigma_kind == "diag":
            return sig * Z0
        return torch.einsum("mij,mi->mj", sig, Z0)

    def z_match_resid(zstate, tgt, w):
        """λ·Δt·Σ_j mask_j (zA_j − C̃_j)² of the previous step, whose σᵀZ_θ
        was zA, against this step's detached target ``tgt``."""
        zA, zbase, dWp, dtp = zstate
        B = tgt.detach() - zbase  # zbase is detached already
        C = B * dWp / dtp
        zA_d = zA.detach()
        corr = torch.sum(zA_d * dWp, dim=-1, keepdim=True) * dWp / dtp - zA_d
        r = (zA - C + corr) ** 2
        mask = z_match_mask.on(r.device)
        if mask is not None:
            r = r * mask
        per_path = torch.sum(r * dtp, dim=-1, keepdim=True)
        return zmatch * weighted_sum(per_path, w)

    def z_match_state(t0, X0, Y0, Z0, tgt, t1, dW):
        """The next step's Z-matching payload: this step's σᵀZ_θ, the
        detached base tgt + φΔt, and this step's (ΔW, Δt)."""
        dt = t1 - t0
        base = (tgt + problem.phi(t0, X0, Y0, Z0) * dt).detach()
        return (z_proj(t0, X0, Y0, Z0), base, dW, dt)

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

    def step(net_u, target, w, ex_flag, eps, t0, X0, Ytilde0, t1, dW, *zstate):
        """One rollout step from the carry (X, Ỹ[, Z-matching state]): the
        residual at t0 against the carried prediction, then the next carry.
        ``ex_flag`` (a Python bool) marks an exercise date; ``eps`` is the
        step's noise (None for a deterministic net)."""
        Y0, Z0 = net_u(t0, X0, eps)
        if local:
            tgt = Y0 if target is None else u_target(target, t0, X0, eps)
            if early and ex_flag:
                # the Snell clamp: the target is the better of exercising now
                # and continuing; the net's u stays the continuation
                tgt = torch.maximum(problem.g(X0), tgt)
            resid = (tgt.detach() - Ytilde0) ** 2
        else:
            resid = (Y0 - Ytilde0) ** 2
        residual = weighted_sum(resid, w)
        if zmatch:
            residual = residual + z_match_resid(zstate, tgt, w)
            zstate = z_match_state(t0, X0, Y0, Z0, tgt, t1, dW)
        X1, Y1_tilde = em_step(t0, X0, Y0, Z0, t1, dW)
        return (X1, Y1_tilde, residual, Y0, *zstate)

    def loss_fn(module: torch.nn.Module, ts: Tensor, dWs: Tensor, X0: Tensor,
                paths: bool = True, target_params: Optional[torch.nn.Module] = None,
                noise: Optional[Callable] = None,
                weights: Optional[Tensor] = None) -> RolloutResult:
        if target_params is not None and not local:
            raise ValueError("target_params requires objective='local'")
        N = dWs.shape[0]
        k_ex = int(problem.exercise_every) if early else 1
        if early and N % k_ex:
            raise ValueError(
                f"N={N} must be a multiple of {problem.name}'s exercise_every={k_ex} "
                "(the maturity must be a date)"
            )
        net_u = bind(module)
        if stochastic and noise is None:
            gen = torch.Generator(device=X0.device).manual_seed(0)
            noise = lambda shape: torch.rand(shape, generator=gen, device=X0.device)  # noqa: E731
        M = X0.shape[0]

        def draw():
            """The next evaluation's noise, drawn outside any recomputed step."""
            return module.draw_noise(noise, M) if stochastic else None

        w = path_weights(X0, weights)
        # step 0, peeled: Y0 comes from this evaluation
        eps = draw()
        Y0, Z0 = net_u(ts[0], X0, eps)
        X, Ytilde = em_step(ts[0], X0, Y0, Z0, ts[1], dWs[0])
        zstate = ()
        if zmatch:
            tgt0 = Y0 if target_params is None else u_target(target_params, ts[0], X0, eps)
            zstate = z_match_state(ts[0], X0, Y0, Z0, tgt0, ts[1], dWs[0])
        Xs, Ys, residuals = [X0, X], [Y0], []
        for n in range(1, N):
            # grid index n is an exercise date when k_ex divides it; the
            # terminal index N carries no clamp (its target is g itself)
            body = functools.partial(step, net_u, target_params, w, n % k_ex == 0, draw())
            if config.remat:
                # the step draws no random numbers (a stochastic net's noise is
                # drawn above and bound in), so there is no RNG state to keep for
                # the recompute (reading it is not allowed while a CUDA graph
                # captures the training iteration)
                kw = {} if save_rule is None else {"context_fn": policy_contexts(save_rule)}
                body = functools.partial(checkpoint, body, use_reentrant=False,
                                         preserve_rng_state=False, **kw)
            X, Ytilde, residual, Yn, *zstate = body(ts[n], X, Ytilde, ts[n + 1], dWs[n], *zstate)
            if paths:
                Xs.append(X)
                Ys.append(Yn)
            residuals.append(residual)
        # the final evaluation closes the rollout: last residual + terminal penalties
        YN, ZN = net_u(ts[-1], X, draw())
        if local:
            # the last step's target is the payoff itself
            final_resid = (problem.g(X).detach() - Ytilde) ** 2
        else:
            final_resid = (YN - Ytilde) ** 2
        loss = weighted_sum(final_resid, w)
        if residuals:
            loss = torch.stack(residuals).sum() + loss
        loss = loss + _terminal_penalty(problem, X, YN, ZN, z_penalty_mask.on(X.device), w, dg)
        if zmatch:
            loss = loss + z_match_resid(zstate, problem.g(X), w)
        if not paths:
            return RolloutResult(loss, None, None, Y0[0, 0])
        Y = torch.stack(Ys + [YN], dim=1)
        return RolloutResult(loss, torch.stack(Xs, dim=1), Y, Y[0, 0, 0])

    return loss_fn


def make_path_loss_fn(
    problem: PDEProblem,
    net: torch.nn.Module,
    config: SolverConfig = SolverConfig(),
) -> Callable:
    """Reference-shaped API: loss(net, t, W, Xi, noise=None) with t
    (M, N+1, 1), W (M, N+1, D), Xi (1, D) or (M, D)."""
    loss_fn = make_loss_fn(problem, net, config)

    def path_loss(module, t: Tensor, W: Tensor, Xi, noise=None) -> RolloutResult:
        M = t.shape[0]
        Xi = torch.as_tensor(Xi, dtype=torch.float32, device=t.device).reshape(-1, problem.dim)
        X0 = Xi.expand(M, problem.dim) if Xi.shape[0] == 1 else Xi
        ts = t.transpose(0, 1)
        dWs = torch.diff(W, dim=1).transpose(0, 1)
        return loss_fn(module, ts, dWs, X0, noise=noise)

    return path_loss
