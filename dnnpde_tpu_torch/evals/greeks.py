"""Greeks of the learned solution by automatic differentiation, the
counterpart of ``dnnpde_tpu/evals/greeks.py``.

delta is the full ∇ₓu (the solver's Z process) and gamma the diagonal of
the input Hessian, both through ``problem.transform_u`` as in training:
``torch.func.jacfwd`` of ``torch.func.grad`` per sample, under ``vmap``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

def _f32(trainer, a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(trainer.device)


def compute_greeks(
    trainer, t, X, use_ema: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(u, delta, gamma_diag) at batched (t, X).

    u: (M, 1); delta = ∇ₓu: (M, D); gamma_diag = diag(∂²u/∂X²): (M, D).
    ``use_ema=True`` evaluates the Polyak/EMA shadow (as
    ``Trainer.predict`` does); the trainer needs ``ema_decay``.
    """
    net = trainer.ema_params if use_ema else trainer.params
    problem = trainer.problem
    t = _f32(trainer, t).reshape(-1, 1)
    X = _f32(trainer, X).reshape(-1, problem.dim)

    def u_single(x, ti):
        raw = net(torch.cat([ti, x])[None, :])
        return problem.transform_u(ti[None, :], x[None, :], raw)[0, 0]

    def per_sample(x, ti):
        return u_single(x, ti), grad(u_single)(x, ti), torch.diagonal(jacfwd(grad(u_single))(x, ti))

    u, delta, gamma = vmap(per_sample)(X, t)
    return (
        u.detach().cpu().numpy()[:, None],
        delta.detach().cpu().numpy(),
        gamma.detach().cpu().numpy(),
    )


def learned_price_surface(trainer, s_values, t_values, dim: int = 0) -> np.ndarray:
    """u(t, x0 with component ``dim`` set to s) over a (t, S) grid, as
    (len(t_values), len(s_values))."""
    net, problem = trainer.params, trainer.problem
    s = _f32(trainer, s_values).reshape(-1)
    t = _f32(trainer, t_values).reshape(-1)
    nt, ns = t.shape[0], s.shape[0]
    X = problem.x0.to(trainer.device).repeat(nt * ns, 1)
    X[:, dim] = s.repeat(nt)
    tcol = t.repeat_interleave(ns)[:, None]
    with torch.no_grad():
        u = problem.transform_u(tcol, X, net(torch.cat([tcol, X], dim=-1)))
    return u.reshape(nt, ns).cpu().numpy()


def heston_greeks(
    trainer, S, v, t, use_ema: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Heston-layout wrapper: (price, delta = ∂u/∂S, gamma = ∂²u/∂S²) over
    batched (S, v) at time t, for a problem with state (S, v)."""
    S = np.atleast_1d(np.asarray(S, np.float32))
    v = np.atleast_1d(np.asarray(v, np.float32))
    X = np.stack([S, v], axis=-1)
    tcol = np.full((S.shape[0], 1), t, np.float32)
    u, delta, gamma = compute_greeks(trainer, tcol, X, use_ema=use_ema)
    return u[:, 0], delta[:, 0], gamma[:, 0]
