"""K4: terminal GBM values for the Monte-Carlo pricers in one CUDA launch.

Counterpart of ``dnnpde_tpu/ops/path_kernel.py``. The kernel
(``csrc/gbm_terminal.cu``) sums each path's N standard normals in registers,
applies the Cholesky factor once to the sum (exact for GBM, whose
log-dynamics are linear in the normals) and writes only S_T (M, D).

Random numbers: the TPU kernel seeds its hardware generator with
``seed + program_id``, so its stream depends on the tile. This port draws
from Philox4x32-10 keyed by ``seed`` with counter (pair p, step n, asset
group g, j) and keeps the TPU kernel's transform:

- uniforms from the top 24 bits, ``(bits >> 8) · 2⁻²⁴``, floored at 1e-12;
- two-branch Box–Muller: the uniform pair (u1 from j = 0, u2 from j = 1) of
  asset 4g + k in pair p gives r·cos(2πu2) to path 2p and r·sin(2πu2) to
  path 2p + 1, with r = √(−2 log u1).

The stream depends on neither the block shape nor ``tile_m``.
:func:`gbm_terminal_reference` computes the same function from the same
stream in PyTorch (Philox in integer arithmetic, accurate log/sqrt/sin/cos/exp,
sums in step order and L's row i summed over j = 0…i) and is the definition
the kernel is held to: each kernel value lies within 1e-5 of its plain value.
The kernel takes the special-function unit's approximations of the
transcendentals (``csrc/gbm_terminal.cu`` says where and why they stay within
that), so the two are not bitwise equal; two launches of the kernel are.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from dnnpde_tpu_torch import tracing
from dnnpde_tpu_torch.numerics.monte_carlo import basket_call_payoff
from dnnpde_tpu_torch.ops.rollout_kernel import _TWO_PI_F32, _seed_key, philox4x32_10
from dnnpde_tpu_torch.runtime import device_of

Tensor = torch.Tensor

_TILE_M = 256


def _check_shape(M: int, N: int, tile_m: int) -> None:
    if M % tile_m != 0:
        raise ValueError(f"M={M} must be a multiple of tile_m={tile_m}")
    if tile_m % 2 != 0:
        raise ValueError(f"tile_m={tile_m} must be even (Box-Muller pairing)")
    if N < 1:
        raise ValueError(f"N={N} must be at least 1")


def _inputs(S0, r: float, sigma, T: float, N: int, chol, device):
    """(S0, a, b, L) on ``device``: a = N·(r − σ²/2)·dt and b = σ·√dt as
    float32 (D,) vectors, L the lower-triangular (D, D) factor or None."""
    S0 = torch.atleast_1d(torch.as_tensor(S0, dtype=torch.float32)).to(device).contiguous()
    D = S0.shape[0]
    sig = torch.as_tensor(sigma, dtype=torch.float32).to(device).expand(D)
    dt = float(T) / N
    a = (N * ((r - 0.5 * sig * sig) * dt)).contiguous()
    b = (sig * float(np.sqrt(np.float32(dt)))).contiguous()  # σ·f32(√f32(dt)), as jnp
    L = None
    if chol is not None:
        L = torch.as_tensor(chol, dtype=torch.float32)
        if L.shape != (D, D):
            raise ValueError(f"chol must be ({D}, {D}), got {tuple(L.shape)}")
        if not torch.equal(L, torch.tril(L)):
            raise ValueError("chol must be lower-triangular (a Cholesky factor)")
        L = L.to(device).contiguous()
    return S0, a, b, L


def _uniform24(bits: Tensor) -> Tensor:
    return torch.clamp((bits >> 8).float() * 2.0**-24, min=1e-12)


def _normal_sums(seed: int, M: int, N: int, D: int, device=None) -> Tensor:
    """The kernel's per-path sums of N standard normals, (M, D) float32,
    summed in step order. M must be even."""
    k0, k1 = _seed_key(seed)
    P, G = M // 2, (D + 3) // 4
    p = torch.arange(P, dtype=torch.int64, device=device)[:, None].expand(P, G)
    g = torch.arange(G, dtype=torch.int64, device=device)[None, :].expand(P, G)
    z = torch.zeros((M, D), dtype=torch.float32, device=device)
    for n in range(N):
        step = torch.full_like(p, n)

        def bits(j: int) -> Tensor:
            words = philox4x32_10(p, step, g, torch.full_like(p, j), k0, k1)
            return torch.stack(words, dim=-1).reshape(P, 4 * G)[:, :D]

        rad = torch.sqrt(-2.0 * torch.log(_uniform24(bits(0))))
        ang = _TWO_PI_F32 * _uniform24(bits(1))
        z[0::2] += rad * torch.cos(ang)
        z[1::2] += rad * torch.sin(ang)
    return z


def _terminal(z: Tensor, S0: Tensor, a: Tensor, b: Tensor, L: Optional[Tensor]) -> Tensor:
    if L is not None:
        zc = torch.zeros_like(z)
        for j in range(z.shape[1]):  # zc[:, i] = Σ_{j ≤ i} z[:, j]·L[i, j], j ascending
            zc[:, j:] += z[:, j:j + 1] * L[j:, j]
        z = zc
    return S0 * torch.exp(a + b * z)


def gbm_terminal_reference(
    seed: int, S0, r: float, sigma, T: float, N: int, M: int,
    chol=None, device=None,
) -> Tensor:
    """Plain version of K4: the same Philox stream and sums in PyTorch, with
    accurate transcendentals, on ``device`` (None: S0's device if it is a tensor, else the
    first CUDA card). M must be even."""
    if M % 2 != 0 or N < 1:
        raise ValueError(f"need an even M and N >= 1, got M={M}, N={N}")
    device = device_of(S0, device=device)
    S0, a, b, L = _inputs(S0, r, sigma, T, N, chol, device)
    return _terminal(_normal_sums(seed, M, N, S0.shape[0], device), S0, a, b, L)


def _lib():
    from dnnpde_tpu_torch.ops import _build

    lib = _build.load("gbm_terminal")
    fn = lib.gbm_terminal
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_ulonglong, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def gbm_terminal(
    seed: int, S0, r: float, sigma, T: float, N: int, M: int,
    chol=None, tile_m: int = _TILE_M, device=None,
) -> Tensor:
    """Terminal GBM values S_T, (M, D) float32: S0·exp((r − σ²/2)T + σ√dt·Σₙzₙ·Lᵀ)
    over N exact-scheme steps, from ``seed``.

    M must be a multiple of ``tile_m``, which must be even, as in the JAX
    package; the values do not depend on ``tile_m``. ``chol`` is the lower
    Cholesky factor of the assets' correlation, or None. ``device``: None
    is S0's device if S0 is a tensor, else the first CUDA card (raises
    without one). On the card this launches K4; on the CPU it runs
    :func:`gbm_terminal_reference`."""
    _check_shape(M, N, tile_m)
    device = device_of(S0, device=device)
    if device.type == "cpu":
        return gbm_terminal_reference(seed, S0, r, sigma, T, N, M, chol=chol, device=device)
    if device.type != "cuda":
        raise ValueError(f"gbm_terminal runs on CUDA or CPU tensors, got {device}")
    from dnnpde_tpu_torch.ops import _build

    S0, a, b, L = _inputs(S0, r, sigma, T, N, chol, device)
    D = S0.shape[0]
    out = torch.empty((M, D), dtype=torch.float32, device=device)
    if M == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.gbm_terminal(
            S0.data_ptr(), a.data_ptr(), b.data_ptr(), None if L is None else L.data_ptr(),
            out.data_ptr(), M, D, N, int(seed) & 0xFFFFFFFFFFFFFFFF, stream,
        )
    _build.check(lib, code, "gbm_terminal")
    tracing.count("ops.gbm_terminal.calls")
    return out


def fused_basket_call_mc(
    seed: int, S0, K: float, T: float, r: float, sigma,
    chol=None, num_paths: int = 131072, num_steps: int = 1, payoff: str = "mean",
    device=None,
) -> tuple[Tensor, Tensor]:
    """Basket-call Monte-Carlo price and standard error on K4: the contract
    of :func:`dnnpde_tpu_torch.numerics.basket_call_mc` with payoff "mean"
    or "sum" (0-d tensors)."""
    if payoff not in ("mean", "sum"):
        raise ValueError(f"unknown payoff {payoff!r}")
    ST = gbm_terminal(seed, S0, r, sigma, T, num_steps, num_paths, chol, device=device)
    return basket_call_payoff(ST, K, r, T, payoff)
