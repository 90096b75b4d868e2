"""The deep-BSDE loss and the first Adam steps, generic over the net: the
equations of ``bsde.py`` (Raissi, arXiv:1804.07010, eq. 7) with the net's
(u, Z) from a ``u_and_z(Ws, bs, t, X, precision, transform)`` of the
caller's choice (``naisnet.u_and_z``; ``mlp.u_and_z`` gives ``bsde.py``'s
loss). The leaves are (W, b) pairs in the net's parameter order. Time grid
and draws are ``bsde.time_grid`` and ``bsde.draws``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from benchmark.reference.bsde import B1, B2, CLIP, EPS

Tensor = torch.Tensor


def loss(problem, u_and_z: Callable, Ws, bs, ts: Tensor, dWs: Tensor, X0: Tensor,
         objective: str, precision: str = "f32", half: bool = False) -> Tensor:
    """The loss of one batch (a scalar); ``half`` is a planted fault for the
    tests: the first M/2 paths only, their sum doubled."""
    if half:
        m = X0.shape[0] // 2
        return 2.0 * loss(problem, u_and_z, Ws, bs, ts, dWs[:, :m], X0[:m], objective,
                          precision)
    local = objective == "local"
    N, M = dWs.shape[0], X0.shape[0]
    tcol = lambda n: ts[n].reshape(1, 1).expand(M, 1)  # noqa: E731

    def net(n, X):
        return u_and_z(Ws, bs, tcol(n), X, precision, problem.transform)

    def step(n, X, Y, Z):
        dt = ts[n + 1] - ts[n]
        sdw = problem.diffuse(tcol(n), X, Y, dWs[n])
        X1 = X + problem.drift(tcol(n), X, Y, Z) * dt + sdw
        Yt = Y + problem.phi(tcol(n), X, Y, Z) * dt + torch.sum(Z * sdw, dim=-1, keepdim=True)
        return X1, Yt

    Y, Z = net(0, X0)
    X, Yt = step(0, X0, Y, Z)
    total = torch.zeros((), device=X0.device)
    for n in range(1, N):
        Y, Z = net(n, X)
        total = total + torch.sum(((Y.detach() if local else Y) - Yt) ** 2)
        X, Yt = step(n, X, Y, Z)
    YN, ZN = net(N, X)
    gN = problem.g(X)
    total = total + torch.sum(((gN.detach() if local else YN) - Yt) ** 2)
    dz = ZN - problem.dg(X)
    if problem.z_mask is not None:
        dz = dz * torch.tensor(problem.z_mask, device=dz.device)
    return total + torch.sum((YN - gN) ** 2) + torch.sum(dz**2)


def train_steps(problem, u_and_z: Callable, Ws: Sequence[Tensor], bs: Sequence[Tensor],
                batches, ts: Tensor, objective: str, lr: float,
                ema_decay: Optional[float] = None, precision: str = "f32",
                fault: Optional[str] = None) -> dict:
    """Adam steps from (Ws, bs) on the given batches, as ``bsde.train_steps``
    takes them: the losses, the first step's gradient after clipping and the
    change of every parameter (and of the EMA shadow) over the steps, as
    lists of leaves in the order W_0, b_0, W_1, b_1, ...; ``fault`` is
    "half" or "unchanged"."""
    params = [p.detach().clone() for pair in zip(Ws, bs) for p in pair]
    start = [p.clone() for p in params]
    ema = [p.clone() for p in params] if ema_decay is not None else None
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses, grad1 = [], None
    for count, (dWs, X0) in enumerate(batches, start=1):
        leaves = [p.requires_grad_(True) for p in params]
        L = loss(problem, u_and_z, leaves[0::2], leaves[1::2], ts, dWs, X0, objective,
                 precision, half=fault == "half")
        grads = torch.autograd.grad(L, leaves)
        losses.append(float(L.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if float(norm) >= CLIP:
                grads = [g / norm * CLIP for g in grads]
            if grad1 is None:
                grad1 = [g.clone() for g in grads]
            if fault == "unchanged":
                params = [p.detach() for p in params]
                continue
            mu = [(1 - B1) * g + B1 * m for g, m in zip(grads, mu)]
            nu = [(1 - B2) * g * g + B2 * v for g, v in zip(grads, nu)]
            c1, c2 = 1 - B1**count, 1 - B2**count
            params = [p.detach() - lr * (m / c1) / (torch.sqrt(v / c2) + EPS)
                      for p, m, v in zip(params, mu, nu)]
            if ema is not None:
                ema = [e + (1 - ema_decay) * (p - e) for e, p in zip(ema, params)]
    out = {"losses": losses, "grad1": grad1,
           "change": [p.detach() - s for p, s in zip(params, start)]}
    if ema is not None:
        out["change"] += [e - s for e, s in zip(ema, start)]
    return out
