"""The fully-connected sine net and its solution (u, Z = ∇ₓu).

Weights are ``Ws`` (in, out) and ``bs`` (out,), the net's input is
[t, X], and u = a_{L-1} W_L + b_L with a_k = sin(a_{k-1} W_k + b_k)
(Raissi, arXiv:1804.07010, §4: the FBSNN's 4 × 256 sine net).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from benchmark.reference.precision import mm

Tensor = torch.Tensor


def forward(Ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor, precision: str = "f32"):
    """The net's raw output (B, 1) at inputs x (B, n0)."""
    a = x
    for W, b in zip(Ws[:-1], bs[:-1]):
        a = torch.sin(mm(a, W, precision) + b)
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
