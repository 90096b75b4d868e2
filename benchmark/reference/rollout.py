"""Learned-solution paths: for paths m < M from x0, Euler–Maruyama on GBM
dynamics, X_{n+1} = X_n + μ_c Δt X_n + σ_c X_n ΔW_n with ΔW_n = √Δt ·
(the Philox normals of step n), and Y[m, n] = u(n Δt, X_n) by the net
(no output transform), for n = 0..N."""

from __future__ import annotations

import torch

from benchmark.reference import philox
from benchmark.reference.mlp import forward
from benchmark.reference.precision import matmul_mode

Tensor = torch.Tensor


def paths(Ws, bs, x0: Tensor, mu_c: float, sig_c: float, N: int, T: float, M: int,
          seed: int, precision: str = "f32", block: int = 4096) -> Tensor:
    """Y (M, N+1) in blocks of ``block`` paths."""
    dt = T / N
    D = x0.shape[0]
    out = []
    with torch.no_grad(), matmul_mode(precision):
        for lo in range(0, M, block):
            m = min(block, M - lo)
            X = x0.reshape(1, D).expand(m, D).clone()
            ys = []
            for n in range(N + 1):
                t = torch.full((m, 1), n * dt, dtype=torch.float32, device=X.device)
                ys.append(forward(Ws, bs, torch.cat([t, X], dim=1), precision))
                if n < N:
                    z = philox.normals(seed, lo, m, n, D, X.device)
                    X = X + (mu_c * dt) * X + sig_c * X * (dt**0.5 * z)
            out.append(torch.cat(ys, dim=1))
    return torch.cat(out, dim=0)
