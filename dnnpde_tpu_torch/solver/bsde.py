"""Deep-BSDE solver pieces of the PyTorch port. So far only ``make_net_u``,
the general (u, Z = ∇ₓu) evaluation that serving uses and that the fused
path is held against."""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor


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
