"""Black–Scholes vega, the part of ``dnnpde_tpu/numerics/implied_vol.py``
ported so far (the implied-volatility solve itself is listed in ROADMAP.md,
Queue 1)."""

from __future__ import annotations

import torch

from dnnpde_tpu_torch.runtime import device_of

Tensor = torch.Tensor

_SQRT2PI = 2.5066282746310002


def bs_vega(S, K, T, r, sigma, q: float = 0.0, device=None) -> Tensor:
    """∂C/∂σ (always ≥ 0) in float32, on the device of the first tensor
    among (S, T, sigma), else on ``device``. Numbers beside a tensor are
    filled on its device (no host-to-device copy, so the call can be
    captured into a CUDA graph)."""
    dev = device_of(S, T, sigma, device=device)
    ref = next((a for a in (S, T, sigma) if isinstance(a, Tensor)), None)

    def f32(a):
        if isinstance(a, Tensor):
            return a.to(device=dev, dtype=torch.float32)
        if ref is not None:
            return torch.full_like(ref, float(a), dtype=torch.float32, device=dev)
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    S = f32(S)
    T = torch.clamp(f32(T), min=1e-12)
    sigma = torch.clamp(f32(sigma), min=1e-12)
    sqrtT = torch.sqrt(T)
    d1 = (torch.log(torch.clamp(S, min=1e-12) / K) + (r - q + 0.5 * sigma**2) * T) / (
        sigma * sqrtT
    )
    phi = torch.exp(-0.5 * d1**2) / _SQRT2PI
    return S * torch.exp(-q * T) * phi * sqrtT
