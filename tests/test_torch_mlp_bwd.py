"""K2's plain version (``ops/mlp_kernel.py::mlp_u_z_bwd_reference``, which
CPU tensors take through ``mlp_u_z_bwd``) against the JAX package: the
Pallas backward in interpret mode (both round dot operands to bf16) and the
f32 hand-derived backward ``_fused_bwd``. The CUDA kernel itself is tested
on the card by ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.ops.fused_net_u import _fused_bwd
from dnnpde_tpu.ops.mlp_kernel import mlp_u_z_bwd_pallas
from dnnpde_tpu_torch.ops.mlp_kernel import (
    MAX_SMEM,
    bwd_cluster_smem_bytes,
    bwd_takes_cluster,
    mlp_u_z_bwd,
    mlp_u_z_bwd_reference,
)

# The Pallas kernels need hidden widths that are multiples of 128 lanes; the
# f32 comparison uses the narrow net of tests/test_fused_net_u.py.
PALLAS_LAYERS = [5, 128, 128, 128, 1]
NARROW_LAYERS = [5, 16, 16, 16, 1]


def _inputs(seed, layers, B):
    rng = np.random.default_rng(seed)
    Ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(layers[:-1], layers[1:])]
    bs = [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in layers[1:]]
    x, u_bar, z_bar = (rng.normal(size=s).astype(np.float32)
                       for s in ((B, layers[0]), (B, 1), (B, layers[0])))
    return Ws, bs, x, u_bar, z_bar


def _port(Ws, bs, x, u_bar, z_bar):
    t = torch.from_numpy
    return mlp_u_z_bwd([t(w) for w in Ws], [t(b) for b in bs], t(x), t(u_bar), t(z_bar))


def _leaves(out):
    W_bars, b_bars, x_bar = out
    return [np.asarray(a) for a in (*W_bars, *b_bars, x_bar)]


@pytest.mark.parametrize("B", [1, 7, 24])
def test_reference_matches_pallas_interpret(B):
    Ws, bs, x, u_bar, z_bar = _inputs(B, PALLAS_LAYERS, B)
    ref = mlp_u_z_bwd_pallas([jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs],
                             jnp.asarray(x), jnp.asarray(u_bar), jnp.asarray(z_bar),
                             interpret=True, tile_b=8)  # B = 24: three TPU tiles
    out = _port(Ws, bs, x, u_bar, z_bar)
    for a, r in zip(_leaves(out), _leaves(ref)):
        assert a.shape == r.shape
        # Same bf16 rounding points, other summation orders: a value within
        # an f32 rounding of a bf16 tie flips and moves what follows by about
        # one bf16 step of one term (the kernels' two-level tolerance).
        d, scale = np.abs(a - r), np.abs(r).max()
        assert d.max() <= 1e-2 * scale and d.mean() <= 1e-4 * scale


@pytest.mark.parametrize("B", [1, 7, 24])
def test_reference_matches_f32_hand_vjp_at_bf16_tolerance(B):
    Ws, bs, x, u_bar, z_bar = _inputs(100 + B, NARROW_LAYERS, B)
    ref = _fused_bwd("sine", (Ws, bs, x), (u_bar, z_bar))
    out = _port(Ws, bs, x, u_bar, z_bar)
    a_all, r_all = _leaves(out), _leaves(ref)
    # bf16 operand precision, as tests/test_mlp_kernel.py:84-90 holds the
    # Pallas kernel against the same f32 backward
    np.testing.assert_allclose(a_all[-1], r_all[-1], rtol=0, atol=2e-2)
    for a, r in zip(a_all[:-1], r_all[:-1]):
        scale = np.abs(r).max() + 1e-6
        np.testing.assert_allclose(a / scale, r / scale, rtol=0, atol=2e-2)


def test_zero_rows_contribute_nothing():
    """A row with zero cotangents leaves every gradient as it is, which is
    how the kernel masks its ragged last tile."""
    Ws, bs, x, u_bar, z_bar = _inputs(5, NARROW_LAYERS, 9)
    full = _port(Ws, bs, x, u_bar, z_bar)
    u_pad, z_pad = u_bar.copy(), z_bar.copy()
    u_pad[4:] = 0.0
    z_pad[4:] = 0.0
    padded = _port(Ws, bs, x, u_pad, z_pad)
    head = _port(Ws, bs, x[:4].copy(), u_bar[:4].copy(), z_bar[:4].copy())
    for a, b in zip(_leaves(padded)[:-1], _leaves(head)[:-1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_leaves(padded)[-1][4:], 0.0)
    assert not np.allclose(_leaves(full)[0], _leaves(padded)[0])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    Ws, bs, x, u_bar, z_bar = (
        [torch.from_numpy(a) for a in v] if isinstance(v, list) else torch.from_numpy(v)
        for v in _inputs(6, NARROW_LAYERS, 4)
    )
    with pytest.raises(ValueError, match="u_bar"):
        mlp_u_z_bwd(Ws, bs, x, u_bar[:3].contiguous(), z_bar)
    with pytest.raises(ValueError, match="z_bar"):
        mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar.double())
    with pytest.raises(ValueError, match="z_bar"):
        mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar.t().contiguous().t())
    with pytest.raises(ValueError, match="1 wide"):
        mlp_u_z_bwd(Ws[:-1], bs[:-1], x, u_bar, z_bar)
    W_bars, b_bars, x_bar = mlp_u_z_bwd_reference(Ws, bs, x, u_bar, z_bar)
    assert [w.shape for w in W_bars] == [w.shape for w in Ws]
    assert [b.shape for b in b_bars] == [b.shape for b in bs]
    assert x_bar.shape == x.shape


# K2's row chain on thread-block clusters (csrc/mlp_u_z_bwd.cu, design 1'):
# taken by shape alone, where a CTA's slices of the weights and its state fit
# 227 KB of shared memory and B is at most 448. (widths, B, bytes of a CTA,
# taken)
CLUSTER_SHAPES = {
    "flagship-b1": ([101, 256, 256, 256, 256, 1], 1, 223968, True),
    "flagship-b100": ([101, 256, 256, 256, 256, 1], 100, 223968, True),
    "flagship-b448": ([101, 256, 256, 256, 256, 1], 448, 223968, True),
    "flagship-b449": ([101, 256, 256, 256, 256, 1], 449, 223968, False),
    "flagship-b2048": ([101, 256, 256, 256, 256, 1], 2048, 223968, False),
    "deeper-b100": ([101, 256, 256, 256, 256, 256, 1], 100, 265056, False),
    "ragged-7-40-24": ([7, 40, 24, 1], 17, 26816, True),
    "ragged-2-16-16": ([2, 16, 16, 1], 300, 26816, True),
    "ragged-9-300-40": ([9, 300, 40, 1], 100, 134560, True),
    # a 2047-D input: W_0's two slices alone take over 300 KB a CTA
    "wide-input": ([2048, 256, 1], 100, 1114464, False),
    "surface-512": ([3, 512, 512, 512, 512, 1], 100, 726368, False),
}


@pytest.mark.parametrize("name", list(CLUSTER_SHAPES))
def test_k2_row_chain_path_is_a_function_of_shape(name):
    widths, B, smem, taken = CLUSTER_SHAPES[name]
    assert bwd_cluster_smem_bytes(widths) == smem
    assert bwd_takes_cluster(widths, B) is taken
    if smem > MAX_SMEM:  # slices too large for a CTA: the one-block row chain at any B
        assert not bwd_takes_cluster(widths, 1)
