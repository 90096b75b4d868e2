"""K1 (``ops/mlp_kernel.py``) and the fused (u, Z) path of the port against
the JAX package: the plain version against the Pallas kernel in interpret
mode (both round dot operands to bf16), the f32 forms against each other,
and the autograd ``make_net_u`` as the oracle of the fused Z. The CUDA
kernel itself is tested on the card by ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.ops.fused_net_u import mlp_u_z as jax_mlp_u_z
from dnnpde_tpu.ops.mlp_kernel import mlp_u_z_fwd_pallas
from dnnpde_tpu_torch.nets import MLP
from dnnpde_tpu_torch.ops.fused_net_u import make_fused_net_u, mlp_u_z
from dnnpde_tpu_torch.ops.mlp_kernel import mlp_u_z_fwd, mlp_u_z_fwd_reference
from dnnpde_tpu_torch.params import extract_mlp_params
from dnnpde_tpu_torch.solver import make_net_u

LAYERS = [5, 128, 128, 1]


def _weights(seed, layers=LAYERS, B=32):
    rng = np.random.default_rng(seed)
    Ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(layers[:-1], layers[1:])]
    bs = [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in layers[1:]]
    x = rng.normal(size=(B, layers[0])).astype(np.float32)
    return Ws, bs, x


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B", [32, 20])
def test_reference_matches_pallas_interpret(B):
    Ws, bs, x = _weights(0, B=B)
    u_k, z_k = mlp_u_z_fwd_pallas([jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs],
                                  jnp.asarray(x), interpret=True)
    u, z = mlp_u_z_fwd_reference(_t(Ws), _t(bs), torch.from_numpy(x))
    assert u.shape == (B, 1) and z.shape == (B, LAYERS[0])
    # same bf16 rounding points; only the f32 summation order differs
    np.testing.assert_allclose(u.numpy(), np.asarray(u_k), rtol=0, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_k), rtol=0, atol=1e-5)


def test_reference_matches_jax_f32_at_bf16_tolerance():
    Ws, bs, x = _weights(1)
    u_ref, z_ref = jax_mlp_u_z(Ws, bs, x)
    u, z = mlp_u_z_fwd(_t(Ws), _t(bs), torch.from_numpy(x))  # CPU tensors: the plain version
    # bf16 operand precision (~8 mantissa bits) through the layers
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=0, atol=1e-2)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=0, atol=1e-2)


@pytest.mark.parametrize("act", ["sine", "tanh", "relu"])
def test_f32_mlp_u_z_matches_jax(act):
    Ws, bs, x = _weights(2)
    u_ref, z_ref = jax_mlp_u_z(Ws, bs, x, act)
    u, z = mlp_u_z(_t(Ws), _t(bs), torch.from_numpy(x), act)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["sine", "tanh"])
def test_make_net_u_autograd_z_equals_fused_z(act):
    net = MLP(LAYERS, act, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.uniform(size=(12, 1)).astype(np.float32))
    X = torch.from_numpy(rng.normal(size=(12, LAYERS[0] - 1)).astype(np.float32))
    u_a, Z_a = make_net_u(net)(t, X)
    u_f, Z_f = make_fused_net_u(LAYERS, act, "torch")(net, t, X)
    assert Z_a.shape == (12, LAYERS[0] - 1)
    torch.testing.assert_close(u_f, u_a, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(Z_f, Z_a, rtol=1e-5, atol=1e-6)


def test_make_net_u_keeps_the_graph_under_grad_and_applies_the_transform():
    net = MLP(LAYERS, "sine", generator=torch.Generator().manual_seed(1), device="cpu")
    t, X = torch.zeros(4, 1), torch.randn(4, LAYERS[0] - 1, generator=torch.Generator().manual_seed(0))
    u, Z = make_net_u(net)(t, X)
    assert u.requires_grad and Z.requires_grad  # a loss on Z can be differentiated
    with torch.no_grad():
        u0, Z0 = make_net_u(net)(t, X)
        floor = float(u0.max()) + 1.0
        uc, Zc = make_net_u(net, lambda t, x, u: torch.clamp(u, min=floor))(t, X)
        us, Zs = make_net_u(net, lambda t, x, u: u + (x**2).sum(-1, keepdim=True))(t, X)
    assert not u0.requires_grad and not Z0.requires_grad
    assert torch.all(uc == floor) and torch.count_nonzero(Zc) == 0  # Z sees the transform
    torch.testing.assert_close(us, u0 + (X**2).sum(-1, keepdim=True))
    torch.testing.assert_close(Zs, Z0 + 2 * X)


def test_cuda_backend_is_forward_only():
    """The "cuda" backend's forward is K1's plain version on CPU tensors,
    with and without grad mode; since K2 it is no longer forward-only: under
    grad mode its outputs carry the kernel pair's backward."""
    net = MLP(LAYERS, "sine", generator=torch.Generator().manual_seed(0), device="cpu")
    t, X = torch.zeros(3, 1), torch.ones(3, LAYERS[0] - 1)
    net_u = make_fused_net_u(LAYERS, "sine", "cuda")
    u_g, Z_g = net_u(net, t, X)
    assert u_g.requires_grad and Z_g.requires_grad
    with torch.no_grad():
        u, Z = net_u(net, t, X)
        Ws, bs = extract_mlp_params(net)
        u_ref, z_ref = mlp_u_z_fwd_reference(Ws, bs, torch.cat([t, X], 1))
    torch.testing.assert_close(u, u_ref, rtol=0, atol=0)
    torch.testing.assert_close(Z, z_ref[:, 1:], rtol=0, atol=0)
    torch.testing.assert_close(u_g.detach(), u, rtol=0, atol=0)
    with pytest.raises(ValueError, match="sine only"):
        make_fused_net_u(LAYERS, "tanh", "cuda")
    with pytest.raises(ValueError, match="backend"):
        make_fused_net_u(LAYERS, "sine", "pallas")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    Ws, bs, x = (_t(a) if isinstance(a, list) else torch.from_numpy(a) for a in _weights(4))
    with pytest.raises(ValueError, match="float32"):
        mlp_u_z_fwd(Ws, bs, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        mlp_u_z_fwd(Ws, bs, x.t().contiguous().t())
    with pytest.raises(ValueError, match=r"Ws\[1\]"):
        mlp_u_z_fwd([Ws[0], Ws[1][:64].contiguous(), Ws[2]], bs, x)
    with pytest.raises(ValueError, match="1 wide"):
        mlp_u_z_fwd(Ws[:-1], bs[:-1], x)
    with pytest.raises(ValueError, match="layers"):
        mlp_u_z_fwd(Ws * 3, bs * 3, x)
