"""Fused (u, ∇ₓu) evaluation for plain MLPs.

  forward:  a₀ = [t, X];  p_k = a_{k-1} W_k + b_k;  a_k = σ(p_k)
            u  = a_{L-1} W_L + b_L
  Z-sweep:  r_{L-1} = W_L[:,0]ᵀ (broadcast);  q_k = r_k ⊙ σ'(p_k);
            r_{k-1} = q_k W_kᵀ;   Z = r₀ (the X-columns)

``mlp_u_z`` is the plain f32 form for sine, tanh and relu; autograd
differentiates through it. The ``"cuda"`` backend of ``make_fused_net_u``
runs the forward on kernel K1 (``ops/mlp_kernel.py``) with bf16 dot operands;
it has no backward yet (that is kernel K2), so it refuses to run where a
gradient could be asked for.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_fwd
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


def make_fused_net_u(
    layers: Sequence[int], activation: str = "sine", backend: str = "torch"
):
    """net_u(net, t, X) → (u, Z) on the fused path, for a port ``MLP`` ``net``
    with ``len(layers) - 1`` dense layers.

    ``backend``: "torch" (any supported activation, any device, differentiable
    by autograd) or "cuda" (sine; K1 on CUDA tensors, its plain version on CPU
    tensors; forward only)."""
    act = activation.lower()
    if act not in _ACT_DERIVS:
        raise ValueError(f"fused net_u supports {sorted(_ACT_DERIVS)}, got {act!r}")
    if backend not in ("torch", "cuda"):
        raise ValueError(f"backend must be 'torch' or 'cuda', got {backend!r}")
    if backend == "cuda" and act != "sine":
        raise ValueError("the CUDA fused net_u kernel supports sine only")

    def net_u(net, t: Tensor, X: Tensor):
        Ws, bs = extract_mlp_params(net)
        if len(Ws) != len(layers) - 1:
            raise ValueError(f"net has {len(Ws)} layers, expected {len(layers) - 1}")
        x = torch.cat([t, X], dim=-1)
        if backend == "torch":
            u, z_full = mlp_u_z(Ws, bs, x, act)
        else:
            if torch.is_grad_enabled() and (
                x.requires_grad or any(w.requires_grad for w in (*Ws, *bs))
            ):
                raise RuntimeError(
                    "the 'cuda' fused net_u is forward-only until its backward "
                    "kernel (K2) is ported; call it under torch.no_grad()"
                )
            u, z_full = mlp_u_z_fwd(list(Ws), list(bs), x.contiguous())
        return u, z_full[:, 1:]  # drop the t column

    return net_u
