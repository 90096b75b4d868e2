"""Operation and byte counts of the NAIS-Net from shapes, as ``roofline``
counts the MLP's: the work the mathematics needs, whatever implements it.

For widths [n0, H, ..., H, n_out] with B = len − 3 blocks, the input layer
is n0·H multiply-adds, each block (H + n0)·H (its −A_i on a_i and its
injection U_i on x) and the head H·n_out: F = 300 288 at [101, 256×4, 1]
(the MLP's 222 720). A training iteration is 12F FLOPs at each of the
M·(N+1) points, as for the MLP, plus the blocks' projections A_i =
clip_F(K_i K_iᵀ) + εI once a loss: one H×H×H product forward and two
backward each, 0.30 GFLOP at H = 256.
"""

from __future__ import annotations

from typing import Sequence


def _blocks(layers: Sequence[int]) -> int:
    return len(layers) - 3


def macs(layers: Sequence[int]) -> int:
    """Multiply-adds of one forward evaluation, head included."""
    return hidden_macs(layers) + layers[1] * layers[-1]


def hidden_macs(layers: Sequence[int]) -> int:
    """Multiply-adds of the input layer and the blocks."""
    n0, H = layers[0], layers[1]
    return n0 * H + _blocks(layers) * (H + n0) * H


def weight_bytes(layers: Sequence[int]) -> int:
    """f32 bytes of the weights a launch reads: the input layer, each
    block's A_i and U_i with its bias, the head."""
    n0, H = layers[0], layers[1]
    return 4 * (n0 * H + H + _blocks(layers) * ((H + n0) * H + H) + H * layers[-1] + layers[-1])


def projection_flops(layers: Sequence[int]) -> float:
    """The blocks' projections a training iteration: three H³ products each."""
    return 3.0 * _blocks(layers) * 2.0 * layers[1] ** 3


def train_nais_flops(layers: Sequence[int], M: int, N: int) -> float:
    """Model FLOPs of one training iteration: 12F at each of the M·(N+1)
    points and the projections."""
    return 12.0 * macs(layers) * M * (N + 1) + projection_flops(layers)


def k1_work(layers: Sequence[int], B: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one K1 launch at B rows: the forward pass and the
    Z-sweep (through the input layer and the blocks); x in, u and Z out."""
    return 2.0 * B * (macs(layers) + hidden_macs(layers)), \
        4.0 * B * (2 * layers[0] + 1) + weight_bytes(layers)


def k2_work(layers: Sequence[int], B: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one K2 launch (its two kernels) at B rows: the
    forward pass recomputed, the sweep's r_k (the blocks' −A_i only), the
    Z-path adjoint (a product and an outer product a layer) and the u-path
    backward; x and both cotangents in, x̄ and the weight gradients out."""
    H = layers[1]
    hidden = hidden_macs(layers)
    sweep = _blocks(layers) * H * H
    per_row = hidden + sweep + 2 * hidden + 2 * H * layers[-1] + 2 * hidden
    return 2.0 * B * per_row, 4.0 * B * (3 * layers[0] + 1) + 2 * weight_bytes(layers)
