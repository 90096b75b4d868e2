"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with ``nvcc`` (marker ``cuda``) and skips
without one. The file imports neither JAX nor the JAX package, so on a machine
without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dnnpde_tpu_torch.ops.fused_net_u import FusedMlpUZ
from dnnpde_tpu_torch.ops.mlp_kernel import (
    mlp_u_z_bwd,
    mlp_u_z_bwd_reference,
    mlp_u_z_fwd,
    mlp_u_z_fwd_reference,
)
from dnnpde_tpu_torch.ops.path_kernel import gbm_terminal, gbm_terminal_reference
from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths, rollout_paths_reference
from dnnpde_tpu_torch.sim import cholesky_factor, generate_correlation_matrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
    return torch.device("cuda")


def _on(device, arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _assert_kernel_close(actual, plain):
    """Both round dot operands to bf16 but sum in other orders, so a value
    near a bf16 tie may flip and move what follows by about a bf16 step of
    one term: at most 1e-2 of max|plain| anywhere, 1e-4 on average."""
    scale = float(plain.abs().max())
    assert actual.shape == plain.shape and bool(torch.isfinite(actual).all())
    assert float((actual - plain).abs().max()) <= 1e-2 * scale
    assert float((actual - plain).abs().mean()) <= 1e-4 * scale


@pytest.mark.parametrize("B", [1, 37, 300])
def test_k1_matches_plain_version(cuda_device, B):
    rng = np.random.default_rng(5)
    layers = [101, 256, 256, 1]
    Ws = _on(cuda_device, [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
                           for a, b in zip(layers[:-1], layers[1:])])
    bs = _on(cuda_device, [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in layers[1:]])
    (x,) = _on(cuda_device, [rng.normal(size=(B, layers[0])).astype(np.float32)])
    before = mlp_u_z_fwd.launches
    u, z = mlp_u_z_fwd(Ws, bs, x)
    torch.cuda.synchronize()
    assert mlp_u_z_fwd.launches == before + 1
    u_ref, z_ref = mlp_u_z_fwd_reference(Ws, bs, x)
    _assert_kernel_close(u, u_ref)
    _assert_kernel_close(z, z_ref)


def test_k1_rejects_what_it_does_not_take(cuda_device):
    Ws = [torch.zeros(5, 8, device=cuda_device), torch.zeros(8, 1, device=cuda_device)]
    bs = [torch.zeros(8, device=cuda_device), torch.zeros(1, device=cuda_device)]
    with pytest.raises(ValueError, match="cpu"):
        mlp_u_z_fwd(Ws, bs, torch.zeros(3, 5))  # weights on the card, x on the CPU


@pytest.mark.parametrize("variant", ["dWs", "seed"])
def test_k3_matches_plain_version(cuda_device, variant):
    rng = np.random.default_rng(2)
    D, H, N, M = 100, 256, 6, 300
    Ws = _on(cuda_device, [(0.1 * rng.normal(size=(D + 1, H))).astype(np.float32),
                           (0.05 * rng.normal(size=(H, H))).astype(np.float32),
                           (0.1 * rng.normal(size=(H, 1))).astype(np.float32)])
    bs = _on(cuda_device, [(0.1 * rng.normal(size=(n,))).astype(np.float32) for n in (H, H, 1)])
    (x0,) = _on(cuda_device, [np.tile([1.0, 0.5], D // 2).astype(np.float32)])
    kw = dict(N=N, dt=1.0 / N, mu_c=0.05, sig_c=0.2)
    if variant == "dWs":
        (kw["dWs"],) = _on(cuda_device, [(0.4 * rng.normal(size=(M, N, D))).astype(np.float32)])
    else:
        kw.update(seed=99, M=M)
    before = rollout_paths.launches
    y = rollout_paths(Ws, bs, x0, **kw)
    torch.cuda.synchronize()
    assert rollout_paths.launches == before + 1
    _assert_kernel_close(y, rollout_paths_reference(Ws, bs, x0, **kw))


FULL = [101, 256, 256, 256, 256, 1]


def _full_width(device, B, seed):
    rng = np.random.default_rng(seed)
    Ws = _on(device, [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
                      for a, b in zip(FULL[:-1], FULL[1:])])
    bs = _on(device, [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in FULL[1:]])
    x, u_bar, z_bar = _on(device, [rng.normal(size=s).astype(np.float32)
                                   for s in ((B, FULL[0]), (B, 1), (B, FULL[0]))])
    return Ws, bs, x, u_bar, z_bar


@pytest.mark.parametrize("B", [1, 100, 2048])
def test_k2_matches_plain_version_and_repeats_bitwise(cuda_device, B):
    Ws, bs, x, u_bar, z_bar = _full_width(cuda_device, B, seed=B)
    before = mlp_u_z_bwd.launches
    W_bars, b_bars, x_bar = mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar)
    again = mlp_u_z_bwd(Ws, bs, x, u_bar, z_bar)
    torch.cuda.synchronize()
    assert mlp_u_z_bwd.launches == before + 2
    W_ref, b_ref, x_ref = mlp_u_z_bwd_reference(Ws, bs, x, u_bar, z_bar)
    for a, r in zip([*W_bars, *b_bars, x_bar], [*W_ref, *b_ref, x_ref]):
        _assert_kernel_close(a, r)
    # per-block partials summed in a fixed order: no run-to-run change
    for a, b in zip([*W_bars, *b_bars, x_bar], [*again[0], *again[1], again[2]]):
        assert torch.equal(a, b)


def test_fused_function_gradients_match_plain_function(cuda_device):
    """FusedMlpUZ on the card (K1 + K2) against the same Function on the
    CPU (the two plain versions), through a loss that feeds Z back in."""
    Ws, bs, x, _, _ = _full_width(cuda_device, 64, seed=9)

    def grads(device):
        wb = [t.detach().to(device).requires_grad_(True) for t in (*Ws, *bs)]
        x_d = x.detach().to(device).requires_grad_(True)
        u, z = FusedMlpUZ.apply(x_d, *wb)
        u2, z2 = FusedMlpUZ.apply((x_d + 0.1 * z).contiguous(), *wb)
        loss = (u2 * u).sum() + (z2 * z).sum()
        return [g.cpu() for g in torch.autograd.grad(loss, [x_d, *wb])]

    before = (mlp_u_z_fwd.launches, mlp_u_z_bwd.launches)
    on_card = grads(cuda_device)
    torch.cuda.synchronize()
    assert (mlp_u_z_fwd.launches, mlp_u_z_bwd.launches) == (before[0] + 2, before[1] + 2)
    for a, r in zip(on_card, grads("cpu")):
        _assert_kernel_close(a, r)


# K4 against its plain version, value by value: both draw the same Philox
# stream and sum, correlate and round in the same order; what differs is the
# last place of libdevice's logf/sincosf/expf against PyTorch's log/sin/cos/exp,
# carried through an N-term sum and amplified by exp. 1e-5 of each value leaves
# room for that; one wrong normal moves a value by about σ√dt ≈ 3e-2.
K4_RTOL = 1e-5


# D = 256: L (256 KB) no longer fits in shared memory beside the z-tile and is
# read from global memory; D = 1024: the z-tile of 32 path pairs (256 KB) does
# not fit either and the launcher halves it to 16 pairs.
@pytest.mark.parametrize("D", [1, 7, 100, 256, 1024])
@pytest.mark.parametrize("correlated", [False, True])
def test_k4_matches_plain_version_and_repeats_bitwise(cuda_device, D, correlated):
    M, N = 2048, 12
    rng = np.random.default_rng(D)
    S0 = rng.uniform(0.5, 1.5, size=D).astype(np.float32)
    sigma = rng.uniform(0.1, 0.4, size=D).astype(np.float32)
    chol = None
    if correlated:
        chol = cholesky_factor(generate_correlation_matrix(D, "random_correlation", seed=D))
    args = (2024, S0, 0.05, sigma, 1.0, N, M)
    before = gbm_terminal.launches
    out = gbm_terminal(*args, chol=chol, device=cuda_device)
    again = gbm_terminal(*args, chol=chol, device=cuda_device)
    other = gbm_terminal(2025, *args[1:], chol=chol, device=cuda_device)
    torch.cuda.synchronize()
    assert gbm_terminal.launches == before + 3
    ref = gbm_terminal_reference(*args, chol=chol, device=cuda_device)
    assert out.shape == (M, D) and bool(torch.isfinite(out).all())
    assert float(((out - ref).abs() / ref.abs()).max()) <= K4_RTOL
    assert torch.equal(out, again)
    assert not torch.allclose(out, other)
    # the values do not depend on tile_m
    assert torch.equal(out, gbm_terminal(*args, chol=chol, tile_m=64, device=cuda_device))
