"""The NAIS-Net and its solution (u, Z = ∇ₓu) (Ciccone et al., NAIS-Net:
Stable Deep Networks from Non-Autonomous Differential Equations, NeurIPS
2018, arXiv:1804.07209; the original repository's ``Functions/naisnet.py``).

For the input x = [t, X] and σ = sin:
  a₁ = σ(x W_in + b_in)
  a_{i+1} = σ(−a_i A_i + b_i + x U_i + c_i) + a_i      for each block i
  u = a W_out + b_out
with A_i = clip_F(K_i K_iᵀ) + εI, ε = 0.01: the clip rescales K_i K_iᵀ by
√δ / √‖K_i K_iᵀ‖_F where that norm passes δ = 1 − 2ε.

The leaves are (W, b) pairs in the order of the port's ``parameters()``: the
input layer, every block's (K_i, b_i), every injection's (U_i, c_i), the
head; matrices in the (in, out) layout.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from benchmark.reference.precision import mm

Tensor = torch.Tensor
EPS = 0.01


def project(K: Tensor) -> Tensor:
    """A = clip_F(K Kᵀ) + εI, in f32."""
    delta = 1.0 - 2.0 * EPS
    kk = K @ K.T
    norm = torch.linalg.norm(kk)
    scale = torch.where(norm > delta, math.sqrt(delta) / torch.sqrt(norm), torch.ones_like(norm))
    return kk * scale + EPS * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)


def forward(Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor, precision: str = "f32"):
    """The net's raw output (B, 1) at inputs x (B, n0)."""
    blocks = (len(Ws) - 2) // 2
    a = torch.sin(mm(x, Ws[0], precision) + bs[0])
    for i in range(blocks):
        K, b = Ws[1 + i], bs[1 + i]
        U, c = Ws[1 + blocks + i], bs[1 + blocks + i]
        a = torch.sin(-mm(a, project(K), precision) + b + mm(x, U, precision) + c) + a
    return mm(a, Ws[-1], precision) + bs[-1]


def u_and_z(Ws, bs, t: Tensor, X: Tensor, precision: str = "f32",
            transform: Optional[Callable] = None, create_graph: bool = True):
    """(u (B,1), Z (B,D)) at (t, X): u = transform(t, X, net([t, X])), Z by
    autograd of Σu; with ``create_graph`` Z keeps its graph for a loss on it."""
    with torch.enable_grad():
        x = X.detach().requires_grad_(True)
        u = forward(Ws, bs, torch.cat([t, x], dim=-1), precision)
        if transform is not None:
            u = transform(t, x, u)
        (Z,) = torch.autograd.grad(u.sum(), x, create_graph=create_graph)
    if not create_graph:
        u, Z = u.detach(), Z.detach()
    return u, Z
