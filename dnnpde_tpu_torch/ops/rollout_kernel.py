"""K3: the whole-rollout kernel, N Euler–Maruyama steps plus a sine-MLP read
per step in one CUDA launch.

Counterpart of ``dnnpde_tpu/ops/rollout_kernel.py``. The kernel
(``csrc/rollout.cu``) gives each block a tile of 128 paths and loops over
the N+1 times inside the block, with the tile's state X and its activations
in shared memory for the whole rollout and the net's dots on tensor cores.
Its device-memory traffic is x0 in, Y out and, in the explicit variant, the
dW tensor. A net too wide for a 128-path tile in shared memory (hidden
widths above 272 at D = 100) takes 16-path tiles, up to 2992 wide at
D = 100; a wider net raises.

Random increments: the TPU kernel seeds its hardware generator per tile. This
port draws them from a counter-based Philox4x32-10 keyed by ``seed`` with
counter (path, step, dim // 4, j), so the stream does not depend on the tile
size, and keeps the TPU's transform: 23-bit uniforms and single-branch
Box–Muller. :func:`philox_normals` reproduces the same stream in PyTorch
integer arithmetic, so the kernel's seed variant is checked value by value
against its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from dnnpde_tpu_torch.ops.mlp_kernel import bf16_dot, check_mlp
from dnnpde_tpu_torch.pde.problems import (
    BasketCallOption,
    BlackScholesBarenblatt,
    BSPDETestCase,
    CallOption1D,
    CallOptionND,
)

Tensor = torch.Tensor

_MASK32 = 0xFFFFFFFF
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def _mulhilo(a: int, c: Tensor) -> tuple[Tensor, Tensor]:
    """(hi, lo) 32-bit halves of a * c for a 32-bit constant and int64
    tensors holding 32-bit values, without overflowing int64."""
    ch, cl = c >> 16, c & 0xFFFF
    p_hi, p_lo = a * ch, a * cl  # a*c = p_hi * 2^16 + p_lo, each < 2^48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox4x32_10(c0: Tensor, c1: Tensor, c2: Tensor, c3: Tensor, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words (the kernel's
    ``philox4x32_10`` in ``csrc/common.cuh``)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def _seed_key(seed: int) -> tuple[int, int]:
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & _MASK32, s >> 32


def philox_normals(seed: int, M: int, n: int, D: int, device=None) -> Tensor:
    """The kernel's standard normals for step ``n``: (M, D) float32."""
    k0, k1 = _seed_key(seed)
    G = (D + 3) // 4
    m = torch.arange(M, dtype=torch.int64, device=device)[:, None].expand(M, G)
    g = torch.arange(G, dtype=torch.int64, device=device)[None, :].expand(M, G)
    step = torch.full_like(m, n)

    def bits(j: int) -> Tensor:
        words = philox4x32_10(m, step, g, torch.full_like(m, j), k0, k1)
        return torch.stack(words, dim=-1).reshape(M, 4 * G)[:, :D]

    u1 = ((bits(0) >> 9).float() + 0.5) * 2.0**-23
    u2 = ((bits(1) >> 9).float() + 0.5) * 2.0**-23
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)


def _check_rollout_args(dWs, seed, M):
    if (dWs is None) == (seed is None):
        raise ValueError("pass exactly one of dWs or seed")
    if dWs is None and M is None:
        raise ValueError("M is required with seed (no dW tensor to infer it)")


def rollout_paths_reference(
    Ws: Sequence[Tensor], bs: Sequence[Tensor], x0: Tensor, *, N: int, dt: float,
    mu_c: float, sig_c: float, dWs: Tensor | None = None, seed: int | None = None,
    M: int | None = None,
) -> Tensor:
    """Plain version of K3: Y (M, N+1) with u(t, X) read through the
    concatenated [t, X] as ``rollout_paths_xla`` does, and the Philox
    normals of :func:`philox_normals` when ``seed`` is given."""
    _check_rollout_args(dWs, seed, M)
    D = x0.shape[-1]
    if dWs is not None:
        M = dWs.shape[0]
    X = x0.to(torch.float32).reshape(1, D).expand(M, D)
    sqrt_dt = float(dt) ** 0.5
    ys = []
    for n in range(N + 1):
        a = torch.cat([torch.full((M, 1), float(n), device=X.device) * dt, X], dim=1)
        for W, b in zip(Ws[:-1], bs[:-1]):
            a = torch.sin(bf16_dot(a, W) + b)
        ys.append(bf16_dot(a, Ws[-1]) + bs[-1])
        if n < N:
            if dWs is not None:
                dw = dWs[:, n]
            else:
                dw = sqrt_dt * philox_normals(seed, M, n, D, X.device)
            X = X + (mu_c * dt) * X + sig_c * X * dw
    return torch.cat(ys, dim=1)


def _lib():
    from dnnpde_tpu_torch.ops import _build

    lib = _build.load("rollout")
    fn = lib.rollout_paths
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 3
            + [ctypes.c_float] * 4
            + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def rollout_paths(
    Ws: Sequence[Tensor], bs: Sequence[Tensor], x0: Tensor, *, N: int, dt: float,
    mu_c: float, sig_c: float, dWs: Tensor | None = None, seed: int | None = None,
    M: int | None = None,
) -> Tensor:
    """Y paths (M, N+1): u(tₙ, Xₙ) along GBM Euler–Maruyama paths from x0 (D,).

    Exactly one of ``dWs`` (M, N, D) explicit increments or ``seed`` (an int,
    with ``M``) for increments drawn in the kernel. CUDA tensors launch K3 on
    the current stream; CPU tensors take :func:`rollout_paths_reference`."""
    _check_rollout_args(dWs, seed, M)
    x0 = x0.reshape(-1)
    D = x0.shape[0]
    device = x0.device
    if x0.dtype != torch.float32:
        raise ValueError(f"x0 must be float32, got {x0.dtype}")
    widths = check_mlp(Ws, bs, device)
    if widths[0] != D + 1:
        raise ValueError(f"the net takes {widths[0]} inputs, expected [t, X] = {D + 1}")
    if dWs is not None:
        M = dWs.shape[0]
        if (dWs.shape != (M, N, D) or dWs.dtype != torch.float32
                or dWs.device != device or not dWs.is_contiguous()):
            raise ValueError(
                f"dWs must be contiguous float32 ({M}, {N}, {D}) on {device}, "
                f"got {dWs.dtype} {tuple(dWs.shape)} on {dWs.device}"
            )
    if device.type == "cpu":
        return rollout_paths_reference(
            Ws, bs, x0, N=N, dt=dt, mu_c=mu_c, sig_c=sig_c, dWs=dWs, seed=seed, M=M
        )
    if device.type != "cuda":
        raise ValueError(f"rollout_paths runs on CUDA or CPU tensors, got {device}")
    from dnnpde_tpu_torch.ops import _build

    Y = torch.empty((M, N + 1), dtype=torch.float32, device=device)
    if M == 0:
        return Y
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.rollout_paths(
            x0.data_ptr(), None if dWs is None else dWs.data_ptr(), Y.data_ptr(),
            _build.pointer_array(Ws), _build.pointer_array(bs), _build.int_array(widths),
            len(Ws), M, N, dt, mu_c * dt, sig_c, float(dt) ** 0.5,
            int(seed or 0) & 0xFFFFFFFFFFFFFFFF, int(dWs is None), stream,
        )
    _build.check(lib, code, "rollout_paths")
    rollout_paths.launches += 1
    return Y


rollout_paths.launches = 0


def gbm_coefficients(problem) -> tuple[float, float] | None:
    """(μ_c, σ_c) when the problem's dynamics are GBM-type (μ = μ_c·X,
    σ = σ_c·diag(X)), else None: BSB (0, σ̄); the 1D/nD calls, the basket
    and the BSB test case (r, σ̄)."""
    if isinstance(problem, BlackScholesBarenblatt):
        return 0.0, float(problem.sigma_bar)
    if isinstance(problem, (CallOption1D, CallOptionND, BasketCallOption, BSPDETestCase)):
        return float(problem.r), float(problem.sigma_bar)
    return None


def predict_paths_fast(trainer, M: int, seed: int = 0) -> Tensor:
    """Y paths (M, N+1) for a trained FC-sine model on a GBM-type problem, in
    one K3 launch with increments drawn in the kernel.

    ``trainer`` is any object with ``problem``, ``params`` (the port's
    ``MLP``), ``N``, ``mode``, ``activation`` and ``chol``. Raises ValueError
    for what the kernel does not cover: non-GBM dynamics, another network,
    an output transform, correlated increments."""
    from dnnpde_tpu_torch.params import extract_mlp_params

    problem = trainer.problem
    coefs = gbm_coefficients(problem)
    if coefs is None:
        raise ValueError(f"{problem.name}: dynamics are not GBM-type")
    if trainer.mode.lower() != "fc" or str(trainer.activation).lower() != "sine":
        raise ValueError("fast rollout supports the FC-sine network only")
    if problem.has_output_transform:
        raise ValueError("fast rollout does not apply output transforms")
    if trainer.chol is not None:
        raise ValueError("fast rollout does not correlate increments")
    with torch.no_grad():
        Ws, bs = extract_mlp_params(trainer.params)
        mu_c, sig_c = coefs
        return rollout_paths(
            list(Ws), list(bs), problem.x0.to(Ws[0].device),
            N=trainer.N, dt=problem.T / trainer.N, mu_c=mu_c, sig_c=sig_c,
            seed=seed, M=M,
        )
