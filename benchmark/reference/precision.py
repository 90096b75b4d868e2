"""Matmul precision of the reference: "f32" (TF32 off), and the lower
precisions its control runs in: "tf32", "bf16", "fp8" (e4m3).

On a CUDA device "tf32" is the card's own TF32 (``allow_tf32``) for every
matmul, backward included. Elsewhere, and for "bf16" and "fp8" everywhere,
both operands of each forward matmul are rounded to the precision and the
product taken in f32 (straight-through: the backward pass sees the rounded
operands and an unrounded cotangent).
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "bf16", "fp8")


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10-bit mantissa, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lsb = (bits >> 13) & 1
    bits = ((bits + 0xFFF + lsb) >> 13) << 13
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32).view_as(x)


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision`` (and back to f32)."""
    if precision == "f32":
        return x
    if precision == "tf32":
        return _tf32_round(x)
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _straight_through(x: torch.Tensor, precision: str) -> torch.Tensor:
    with torch.no_grad():
        r = round_to(x.detach(), precision)
    return x + (r - x).detach() if x.requires_grad else r


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in ``precision``."""
    if precision == "f32" or (precision == "tf32" and a.device.type == "cuda"):
        return a @ b
    return _straight_through(a, precision) @ _straight_through(b, precision)


@contextlib.contextmanager
def matmul_mode(precision: str):
    """TF32 on for "tf32" on the card, off otherwise; the caller's settings
    are restored after."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
