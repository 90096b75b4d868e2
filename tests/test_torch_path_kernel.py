"""K4's plain version (``ops/path_kernel.py``) against the JAX package's
``pallas_gbm_terminal``, which on the CPU runs its golden model
``_gbm_terminal_reference`` (threefry normals). The two streams differ, so
they are compared by moments and correlation; the port's own stream is
checked against the documented Philox pairing rule. The CUDA kernel itself
is held against this plain version on the card by ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dnnpde_tpu.ops import pallas_basket_call_mc, pallas_gbm_terminal
from dnnpde_tpu.sim import cholesky_factor, generate_correlation_matrix
from dnnpde_tpu_torch.numerics import black_scholes_call
from dnnpde_tpu_torch.ops.path_kernel import (
    _normal_sums,
    _uniform24,
    fused_basket_call_mc,
    gbm_terminal,
    gbm_terminal_reference,
)
from dnnpde_tpu_torch.ops.rollout_kernel import _TWO_PI_F32, philox4x32_10

M, N, D = 2048, 5, 3


def _st(seed, *args, **kw):
    return gbm_terminal(seed, *args, device="cpu", **kw).numpy()


def test_moments_match_jax():
    port = _st(0, np.ones(D), 0.05, 0.2, 1.0, N, M)
    ref = np.asarray(pallas_gbm_terminal(0, np.ones(D), 0.05, 0.2, 1.0, N, M))
    assert port.shape == ref.shape == (M, D) and (port > 0).all()
    se = 0.2 / np.sqrt(M)  # of the mean of log S_T per asset
    for logs in (np.log(port), np.log(ref)):
        np.testing.assert_allclose(logs.mean(0), 0.03, atol=4 * se)  # (r − σ²/2)T
        np.testing.assert_allclose(logs.std(0), 0.2, rtol=0.06)       # σ√T
    assert abs(np.log(port).mean() - np.log(ref).mean()) < 4 * np.sqrt(2 / D) * se


def test_correlation_matches_jax():
    C = generate_correlation_matrix(D, "random_correlation", seed=1)
    L = cholesky_factor(C)
    port = _st(1, np.ones(D), 0.0, 0.3, 1.0, N, 4096, chol=L)
    ref = np.asarray(pallas_gbm_terminal(1, np.ones(D), 0.0, 0.3, 1.0, N, 4096, chol=L))
    for st in (port, ref):
        assert np.abs(np.corrcoef(np.log(st).T) - C).max() < 0.08


def test_determinism_and_distinct_seeds():
    a = _st(7, np.ones(D), 0.05, 0.2, 1.0, N, M)
    b = _st(7, np.ones(D), 0.05, 0.2, 1.0, N, M)
    c = _st(8, np.ones(D), 0.05, 0.2, 1.0, N, M)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    assert not np.allclose(a[: M // 2], a[M // 2:])  # no tile repeats another


def test_values_do_not_depend_on_the_tile():
    a = _st(3, np.ones(D), 0.05, 0.2, 1.0, N, 512, tile_m=256)
    for tile_m in (2, 64, 512):
        np.testing.assert_array_equal(a, _st(3, np.ones(D), 0.05, 0.2, 1.0, N, 512,
                                             tile_m=tile_m))


def test_shape_errors_as_in_jax():
    with pytest.raises(ValueError, match="multiple of tile_m"):
        gbm_terminal(0, np.ones(D), 0.05, 0.2, 1.0, N, 100, device="cpu")
    with pytest.raises(ValueError, match="must be even"):
        gbm_terminal(0, np.ones(D), 0.05, 0.2, 1.0, N, 99, tile_m=3, device="cpu")
    for tile_m, m in ((256, 100), (3, 99)):  # the JAX package raises the same
        with pytest.raises(ValueError):
            pallas_gbm_terminal(0, np.ones(D), 0.05, 0.2, 1.0, N, m, tile_m=tile_m)
    with pytest.raises(ValueError, match="lower-triangular"):
        gbm_terminal(0, np.ones(2), 0.0, 0.2, 1.0, N, 256, chol=np.ones((2, 2)), device="cpu")


def test_stream_follows_the_pairing_rule():
    """Path 2p gets r·cos(2πu2), path 2p+1 r·sin(2πu2), with (u1, u2) the
    24-bit uniforms of Philox words j = 0 and 1 at counter (p, n, g)."""
    seed, m, n_steps, d = 12345, 6, 2, 5
    z = _normal_sums(seed, m, n_steps, d)
    want = np.zeros((m, d), np.float32)
    for p in range(m // 2):
        for n in range(n_steps):
            for i in range(d):
                g, k = divmod(i, 4)
                c = [torch.tensor([v], dtype=torch.int64) for v in (p, n, g)]
                u = [float(_uniform24(philox4x32_10(*c, torch.tensor([j]), seed, 0)[k]))
                     for j in (0, 1)]
                rad = np.sqrt(-2.0 * np.log(u[0]))
                want[2 * p, i] += rad * np.cos(2 * np.pi * u[1])
                want[2 * p + 1, i] += rad * np.sin(2 * np.pi * u[1])
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-5, atol=1e-5)


def test_uniform_floor():
    bits = torch.tensor([0, 255, 256, 0xFFFFFFFF], dtype=torch.int64)
    u = _uniform24(bits)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(
        u.numpy(), np.float32([1e-12, 1e-12, 2.0**-24, 1.0 - 2.0**-24]))
    assert np.isfinite(np.sqrt(-2.0 * np.log(u.numpy()))).all()


def test_integer_built_uniform_and_angle_for_all_2_24_values():
    """The kernel builds its uniforms without a conversion instruction
    (``csrc/gbm_terminal.cu::uniform24``, ``angle24``): for s = bits >> 8,
    the float x with bits 0x3F000000 | (s & 0x7FFFFF) is 1/2 + low·2⁻²⁴; u1
    is x minus 0 (bit 31 set) or 1/2, bit for bit the plain version's
    float(s)·2⁻²⁴, and the angle is one FMA of x with 2π and −π or −2π
    (−π's bits with the exponent's lowest bit set when bit 31 is clear),
    equal to fl(2π·(u − 1/2)). Every s < 2²⁴."""
    s = np.arange(1 << 24, dtype=np.uint32)
    bits = s << np.uint32(8)
    x = (np.uint32(0x3F000000) | (s & np.uint32(0x7FFFFF))).view(np.float32)
    sign = (bits.view(np.int32) >> 31).view(np.uint32)
    u1 = x - (~sign & np.uint32(0x3F000000)).view(np.float32)
    want = _uniform24(torch.from_numpy(bits.astype(np.int64))).numpy()
    want[0] = 0.0  # the floor at 1e-12, which the kernel applies to this value
    np.testing.assert_array_equal(u1, want)
    two_pi = np.float32(_TWO_PI_F32)
    c = ((~s & np.uint32(0x800000)) | np.uint32(0xC0490FDB)).view(np.float32)
    assert np.float32(-2 * np.float64(np.float32(np.pi))) == np.float32(-two_pi)
    fma = (x.astype(np.float64) * np.float64(two_pi) + c.astype(np.float64)).astype(np.float32)
    exact = (np.float64(two_pi) * (want.astype(np.float64) - 0.5)).astype(np.float32)
    np.testing.assert_array_equal(fma, exact)


def test_correlation_applied_once_to_the_sum():
    C = generate_correlation_matrix(4, "random_correlation", seed=3)
    L = cholesky_factor(C)
    S0, sig = np.float32([1.0, 0.5, 2.0, 1.5]), np.float32([0.2, 0.3, 0.1, 0.25])
    got = gbm_terminal_reference(5, S0, 0.02, sig, 2.0, 4, 64, chol=L, device="cpu")
    z = _normal_sums(5, 64, 4, 4) @ torch.from_numpy(L).T
    want = torch.from_numpy(S0) * torch.exp(
        4 * (0.02 - 0.5 * torch.from_numpy(sig) ** 2) * 0.5 + torch.from_numpy(sig) * 0.5**0.5 * z)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(
        got.numpy(), _st(5, S0, 0.02, sig, 2.0, 4, 64, chol=L, tile_m=64))


@pytest.mark.parametrize("payoff", ["mean", "sum"])
def test_fused_basket_call_mc_matches_black_scholes(payoff):
    p, se = fused_basket_call_mc(3, np.ones(1), 1.0, 1.0, 0.05, 0.2, num_paths=16384,
                                 num_steps=2, payoff=payoff, device="cpu")
    exact = float(black_scholes_call(1.0, 1.0, 1.0, 0.05, 0.2, device="cpu"))
    assert p.shape == () and abs(float(p) - exact) < 4 * float(se)
    pj, sej = pallas_basket_call_mc(3, np.ones(1), 1.0, 1.0, 0.05, 0.2, num_paths=16384,
                                    num_steps=2, payoff=payoff)
    assert abs(float(p) - float(pj)) < 4 * np.hypot(float(se), float(sej))
    with pytest.raises(ValueError, match="unknown payoff"):
        fused_basket_call_mc(3, np.ones(1), 1.0, 1.0, 0.05, 0.2, num_paths=256,
                             payoff="weighted", device="cpu")
