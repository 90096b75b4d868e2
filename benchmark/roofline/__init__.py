"""Operation and byte counts from shapes, and the card's data-sheet peaks.

The counts read the work the mathematics needs, whatever implements it, so
they do not move when a later change takes a kernel out or changes remat.
For a net of widths w_0 .. w_L, F = Σ_k w_k·w_{k+1} is the multiply-adds of
one forward evaluation (BSB-100 on [101, 256×4, 1]: F = 222 720).

- A training iteration evaluates (u, Z) and its gradient at M·(N+1) points
  (t_n, X_n), under either objective: the local one takes its targets from
  the same evaluations, detached, and evaluates nothing more. (u, Z) is the
  forward pass and the Z-sweep, 4F FLOPs; their gradient twice that; 12F in
  all, 13.6 GFLOP an iteration for BSB-100 at M = 100, N = 50. Remat's
  recompute is not counted.
- A rollout request reads u at M·(N+1) points: 2F FLOPs each.
- Each input byte is read once and each output byte written once; the
  weights once per launch.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s in bf16 on the tensor
cores, 67 TFLOP/s in f32 outside them (TF32 off), 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Sequence

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def macs(layers: Sequence[int], n: int | None = None) -> int:
    """Multiply-adds of the first ``n`` dense layers (all by default)."""
    n = len(layers) - 1 if n is None else n
    return sum(layers[k] * layers[k + 1] for k in range(n))


def weight_bytes(layers: Sequence[int]) -> int:
    return 4 * sum(layers[k] * layers[k + 1] + layers[k + 1] for k in range(len(layers) - 1))


def train_flops(layers: Sequence[int], M: int, N: int) -> float:
    """Model FLOPs of one training iteration."""
    return 12.0 * macs(layers) * M * (N + 1)


def rollout_flops(layers: Sequence[int], M: int, N: int) -> float:
    """Model FLOPs of one rollout request of M paths."""
    return 2.0 * macs(layers) * M * (N + 1)


def k1_work(layers: Sequence[int], B: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one K1 launch at B rows: the forward pass and the
    Z-sweep through the hidden layers; x in, u and Z out."""
    L = len(layers) - 1
    flops = 2.0 * B * (macs(layers, L) + macs(layers, L - 1))
    return flops, 4.0 * B * (2 * layers[0] + 1) + weight_bytes(layers)


def k2_work(layers: Sequence[int], B: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one K2 launch (its two kernels) at B rows: the
    forward pass recomputed, the sweep, the Z-path adjoint (a product and
    an outer product per layer) and the u-path backward; x and both
    cotangents in, x̄ and the weight gradients out."""
    L = len(layers) - 1
    hidden = macs(layers, L - 1)
    sweep = sum(layers[k] * layers[k + 1] for k in range(1, L - 1))
    per_row = hidden + sweep + 2 * hidden + 2 * layers[L - 1] + 2 * hidden
    return 2.0 * B * per_row, 4.0 * B * (3 * layers[0] + 1) + 2 * weight_bytes(layers)


def k3_work(layers: Sequence[int], M: int, N: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one K3 launch: x0 in, Y (M, N+1) out, increments
    drawn in the kernel."""
    D = layers[0] - 1
    return rollout_flops(layers, M, N), 4.0 * (D + M * (N + 1)) + weight_bytes(layers)


def bound_s(flops: float, nbytes: float, precision: str = "bf16") -> float:
    """The least time the card could take: the larger of the operations
    over the peak of ``precision`` and the bytes over the bandwidth."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)
