"""Black–Scholes implied volatility and vega, the counterpart of
``dnnpde_tpu/numerics/implied_vol.py``.

Method: a safeguarded Newton step on σ inside a bisection bracket, run a
fixed number of iterations (64, from σ = 0.5) with no data-dependent
control flow. Price is strictly increasing in σ, so the residual's sign
moves the bracket [lo, hi]; a Newton step that leaves the bracket (or is
not finite) is replaced by the bracket's midpoint, and 64 iterations halve
the bracket to ~5e-20 even if every Newton step were rejected.

The solve is differentiable by the implicit-function theorem
(``torch.autograd.Function``, as JAX's ``custom_vjp``): at the root
C(σ*) = price, dσ/dprice = 1/vega and dσ/dθ = −(∂C/∂θ)/vega for
θ ∈ {S, K, T, r}, each cotangent summed back to its primal's shape.
"""

from __future__ import annotations

import torch

from dnnpde_tpu_torch.numerics.black_scholes import black_scholes_call
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


def _solve_iv(price, S, K, T, r, q, lo, hi, iters) -> Tensor:
    """The safeguarded Newton iterations on broadcast float32 tensors."""
    sigma = torch.full_like(price, 0.5)
    lo_t = torch.full_like(price, lo)
    hi_t = torch.full_like(price, hi)
    for _ in range(iters):
        c = black_scholes_call(S, K, T, r, sigma, q)
        v = bs_vega(S, K, T, r, sigma, q)
        # bracket update from the sign of the residual (price monotone in σ)
        too_low = c < price
        lo_t = torch.where(too_low, sigma, lo_t)
        hi_t = torch.where(too_low, hi_t, sigma)
        newton = sigma - (c - price) / torch.clamp(v, min=1e-12)
        in_bracket = (newton > lo_t) & (newton < hi_t) & torch.isfinite(newton)
        sigma = torch.where(in_bracket, newton, 0.5 * (lo_t + hi_t))
    return sigma


def _unbroadcast(x: Tensor, shape: torch.Size) -> Tensor:
    """Sum a broadcast-shaped cotangent back to its primal's ``shape``."""
    if x.shape == shape:
        return x
    n_lead = x.dim() - len(shape)
    if n_lead:
        x = x.sum(dim=tuple(range(n_lead)))
    stretched = tuple(i for i, s in enumerate(shape) if s == 1 and x.shape[i] != 1)
    if stretched:
        x = x.sum(dim=stretched, keepdim=True)
    return x.reshape(shape)


class _ImpliedVol(torch.autograd.Function):
    """Forward: the solve on the broadcast inputs. Backward: the
    implicit-function VJP (JAX's ``_iv_bwd``)."""

    @staticmethod
    def forward(ctx, price, S, K, T, r, q, lo, hi, iters, device):
        dev = device_of(price, S, K, T, r, device=device)
        args = [a.to(device=dev, dtype=torch.float32) if isinstance(a, Tensor)
                else torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (price, S, K, T, r)]
        ctx.shapes = [a.shape for a in args]
        ctx.q = q
        b = torch.broadcast_tensors(*args)
        sigma = _solve_iv(*b, q, lo, hi, iters)
        ctx.save_for_backward(sigma, *b[1:])
        return sigma

    @staticmethod
    def backward(ctx, g):
        sigma, S, K, T, r = ctx.saved_tensors
        vega = torch.clamp(bs_vega(S, K, T, r, sigma, ctx.q), min=1e-12)
        with torch.enable_grad():
            theta = [a.detach().requires_grad_(True) for a in (S, K, T, r)]
            price = black_scholes_call(*theta[:2], theta[2], theta[3], sigma.detach(), ctx.q)
            grads = torch.autograd.grad(price.sum(), theta)
        coef = g / vega
        cots = [coef] + [-coef * d for d in grads]
        out = [_unbroadcast(c, s) if need else None
               for c, s, need in zip(cots, ctx.shapes, ctx.needs_input_grad[:5])]
        return (*out, None, None, None, None, None)


def implied_vol(price, S, K, T, r, q: float = 0.0, lo: float = 1e-4, hi: float = 5.0,
                iters: int = 64, device=None) -> Tensor:
    """Black–Scholes implied volatility of a call ``price``, broadcast over
    its five inputs, in float32 on the device of the first tensor among
    them, else on ``device``. Prices at or below intrinsic return ``lo``;
    prices above the σ → ``hi`` price return ``hi`` (no NaN).
    Differentiable in (price, S, K, T, r) by the implicit-function theorem."""
    return _ImpliedVol.apply(price, S, K, T, r, q, lo, hi, iters, device)
