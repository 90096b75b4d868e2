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

from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_fwd, mlp_u_z_fwd_reference
from dnnpde_tpu_torch.ops.rollout_kernel import rollout_paths, rollout_paths_reference

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
