"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC'11) in int64 tensor arithmetic, and the normals that the
rollout kernel draws from it: key = the request's 64-bit seed, counter =
(path, step, dim // 4, j); 23-bit uniforms ((bits >> 9) + 0.5)·2⁻²³ from
j = 0 and j = 1, and one branch of Box–Muller, √(−2 ln u₁)·cos(2π u₂).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor
_M32 = 0xFFFFFFFF
_MUL0, _MUL1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mul_hi_lo(a: int, b: Tensor) -> tuple[Tensor, Tensor]:
    """The high and low 32 bits of the 64-bit product a·b (b < 2³²)."""
    b_hi, b_lo = b >> 16, b & 0xFFFF
    hi_part, lo_part = a * b_hi, a * b_lo  # a·b = hi_part·2¹⁶ + lo_part
    low = ((hi_part << 16) + lo_part) & _M32
    high = (hi_part + (lo_part >> 16)) >> 16
    return high, low


def philox(counter: tuple[Tensor, Tensor, Tensor, Tensor], key: int) -> list[Tensor]:
    """Ten rounds of Philox4x32 on the four counter words (int64 tensors
    holding 32-bit values) with the 64-bit ``key``."""
    x0, x1, x2, x3 = counter
    k0, k1 = key & _M32, (key >> 32) & _M32
    for _ in range(10):
        h0, l0 = _mul_hi_lo(_MUL0, x0)
        h1, l1 = _mul_hi_lo(_MUL1, x2)
        x0, x1, x2, x3 = h1 ^ x1 ^ k0, l1, h0 ^ x3 ^ k1, l0
        k0, k1 = (k0 + _W0) & _M32, (k1 + _W1) & _M32
    return [x0, x1, x2, x3]


def normals(seed: int, first: int, M: int, step: int, D: int, device) -> Tensor:
    """The standard normals (M, D) of paths first .. first + M − 1 at one
    time step."""
    G = (D + 3) // 4
    path = torch.arange(first, first + M, dtype=torch.int64, device=device)
    path = path.reshape(M, 1).expand(M, G)
    group = torch.arange(G, dtype=torch.int64, device=device).reshape(1, G).expand(M, G)
    n = torch.full_like(path, step)
    key = int(seed) & 0xFFFFFFFFFFFFFFFF

    def uniform(j: int) -> Tensor:
        words = philox((path, n, group, torch.full_like(path, j)), key)
        bits = torch.stack(words, dim=-1).reshape(M, 4 * G)[:, :D]
        return ((bits >> 9).to(torch.float32) + 0.5) * 2.0**-23

    u1, u2 = uniform(0), uniform(1)
    two_pi = torch.tensor(6.2831855, dtype=torch.float32)  # 2π rounded to f32
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
