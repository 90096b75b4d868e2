"""Fused (u, ∇ₓu) evaluation for plain MLPs.

  forward:  a₀ = [t, X];  p_k = a_{k-1} W_k + b_k;  a_k = σ(p_k)
            u  = a_{L-1} W_L + b_L
  Z-sweep:  r_{L-1} = W_L[:,0]ᵀ (broadcast);  q_k = r_k ⊙ σ'(p_k);
            r_{k-1} = q_k W_kᵀ;   Z = r₀ (the X-columns)

``mlp_u_z`` is the plain f32 form for sine, tanh and relu; autograd
differentiates through it (the ``"torch"`` backend). The ``"cuda"`` backend
is :class:`FusedMlpUZ`, the counterpart of
``dnnpde_tpu/ops/fused_net_u.py::fused_mlp_u_z_pallas``: its forward is
kernel K1 and its backward the hand-derived first-order VJP on kernel K2
(``ops/mlp_kernel.py``), both with bf16 dot operands. CPU tensors take the
two kernels' plain versions.

The NAIS-Net takes the same two paths (``nais_u_z`` and
:class:`FusedNaisUZ`) with its weights in the kernels' layout
(``params.extract_nais_params``): a block k is one layer on [x, a_k] with
weight ``[U_k; 0; -A_k]`` and a residual,

  forward:  a₁ = σ(x W₀ + b₀);  a_{k+1} = σ([x, a_k] W_k + b_k) + a_k
  Z-sweep:  q_k = r_{k+1} ⊙ σ'(p_k);  r_k = r_{k+1} + q_k (−A_k)ᵀ;
            Z = q₀ W₀ᵀ + Σ_k q_k U_kᵀ
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_bwd, mlp_u_z_fwd, round16
from dnnpde_tpu_torch.params import extract_mlp_params

Tensor = torch.Tensor

# activation σ and σ'
_ACT_DERIVS: dict[str, tuple[Callable, Callable]] = {
    "sine": (torch.sin, torch.cos),
    "tanh": (torch.tanh, lambda p: 1.0 - torch.tanh(p) ** 2),
    "relu": (lambda p: torch.clamp(p, min=0.0), lambda p: (p > 0).to(p.dtype)),
}


def mlp_u_z(Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor, act: str = "sine"):
    """Plain f32 reference: (u (B,1), Z_full (B, n0)) for x = [t, X]."""
    sig, dsig = _ACT_DERIVS[act]
    L = len(Ws)
    a, ps = x, []
    for k in range(L - 1):
        p = a @ Ws[k] + bs[k]
        a = sig(p)
        ps.append(p)
    u = a @ Ws[L - 1] + bs[L - 1]
    r = Ws[L - 1][:, 0].expand(x.shape[0], Ws[L - 1].shape[0])
    for k in range(L - 2, -1, -1):
        r = (r * dsig(ps[k])) @ Ws[k].T
    return u, r


def nais_u_z(Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor, act: str = "sine"):
    """Plain f32 NAIS-Net: (u (B,1), Z_full (B, n0)) for x = [t, X], with
    the weights in the kernels' layout (the blocks' ``[U_k; 0; -A_k]``)."""
    sig, dsig = _ACT_DERIVS[act]
    L, n0 = len(Ws), x.shape[1]
    n0p = round16(n0)
    xp = torch.nn.functional.pad(x, (0, n0p - n0))
    ps = [x @ Ws[0] + bs[0]]
    a = sig(ps[0])
    for k in range(1, L - 1):
        ps.append(torch.cat([xp, a], dim=-1) @ Ws[k] + bs[k])
        a = sig(ps[k]) + a
    u = a @ Ws[L - 1] + bs[L - 1]
    r = Ws[L - 1][:, 0].expand(x.shape[0], Ws[L - 1].shape[0])
    zx = 0.0
    for k in range(L - 2, 0, -1):
        q = r * dsig(ps[k])
        zx = zx + q @ Ws[k][:n0].T
        r = r + q @ Ws[k][n0p:].T
    return u, (r * dsig(ps[0])) @ Ws[0].T + zx


def _fused_fwd(ctx, x: Tensor, wb, nais: bool):
    L = len(wb) // 2
    ctx.save_for_backward(x, *wb)
    return mlp_u_z_fwd(list(wb[:L]), list(wb[L:]), x, nais=nais)


def _fused_bwd(ctx, u_bar: Tensor, z_bar: Tensor, nais: bool):
    x, *wb = ctx.saved_tensors
    L = len(wb) // 2
    W_bars, b_bars, x_bar = mlp_u_z_bwd(
        wb[:L], wb[L:], x, u_bar.contiguous(), z_bar.contiguous(), nais=nais
    )
    return (x_bar, *W_bars, *b_bars)


class FusedMlpUZ(torch.autograd.Function):
    """(u (B,1), Z_full (B,n0)) of a sine MLP at x = [t, X], differentiable
    once: ``FusedMlpUZ.apply(x, *Ws, *bs)``. Only (x, Ws, bs) are saved; the
    backward recomputes the rest (K2 on CUDA tensors)."""

    @staticmethod
    def forward(ctx, x: Tensor, *wb: Tensor):
        return _fused_fwd(ctx, x, wb, False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, u_bar: Tensor, z_bar: Tensor):
        return _fused_bwd(ctx, u_bar, z_bar, False)


class FusedNaisUZ(torch.autograd.Function):
    """:class:`FusedMlpUZ` for a sine NAIS-Net, its weights in the kernels'
    layout (``params.extract_nais_params``): K1's and K2's NAIS forms."""

    @staticmethod
    def forward(ctx, x: Tensor, *wb: Tensor):
        return _fused_fwd(ctx, x, wb, True)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, u_bar: Tensor, z_bar: Tensor):
        return _fused_bwd(ctx, u_bar, z_bar, True)


def fused_u_z(Ws: Sequence[Tensor], bs: Sequence[Tensor], t: Tensor, X: Tensor,
              act: str = "sine", backend: str = "torch", nais: bool = False):
    """(u, Z) at (t, X) for the MLP with weights (Ws, bs) in the JAX layout
    (``params.extract_mlp_params``), or with ``nais`` the NAIS-Net with its
    weights in the kernels' layout (``params.extract_nais_params``): the
    fused path without the per-call weight extraction, for callers that
    evaluate the same weights many times (a loss, the rollout)."""
    x = torch.cat([t, X], dim=-1).contiguous()
    if backend == "torch":
        u, z_full = (nais_u_z if nais else mlp_u_z)(Ws, bs, x, act)
    else:
        u, z_full = (FusedNaisUZ if nais else FusedMlpUZ).apply(x, *Ws, *bs)
    return u, z_full[:, 1:]  # drop the t column


def check_fused(activation: str, backend: str) -> str:
    """Validate a (activation, backend) pair of the fused path; returns the
    activation's lower-case name."""
    act = str(activation).lower()
    if act not in _ACT_DERIVS:
        raise ValueError(f"fused net_u supports {sorted(_ACT_DERIVS)}, got {act!r}")
    if backend not in ("torch", "cuda"):
        raise ValueError(f"backend must be 'torch' or 'cuda', got {backend!r}")
    if backend == "cuda" and act != "sine":
        raise ValueError("the CUDA fused net_u kernels support sine only")
    return act


def make_fused_net_u(
    layers: Sequence[int], activation: str = "sine", backend: str = "torch"
):
    """net_u(net, t, X) → (u, Z) on the fused path, for a port ``MLP`` ``net``
    with ``len(layers) - 1`` dense layers.

    ``backend``: "torch" (any supported activation, any device, differentiable
    by autograd) or "cuda" (sine; K1 forward and K2 backward on CUDA tensors,
    their plain versions on CPU tensors; differentiable once)."""
    act = check_fused(activation, backend)

    def net_u(net, t: Tensor, X: Tensor):
        Ws, bs = extract_mlp_params(net)
        if len(Ws) != len(layers) - 1:
            raise ValueError(f"net has {len(Ws)} layers, expected {len(layers) - 1}")
        return fused_u_z(Ws, bs, t, X, act, backend)

    return net_u
