"""The port's differentiable fused (u, Z) paths against the JAX package's
custom-VJP ones, through the scalar of tests/test_fused_net_u.py:51-56,
which feeds Z back into a second evaluation as the rollout does:
``FusedMlpUZ`` (the "cuda" backend; on CPU tensors K1's and K2's plain
versions) against ``fused_mlp_u_z_pallas(interpret=True)``, and the "torch"
backend (autograd through the f32 ``mlp_u_z``) against ``fused_mlp_u_z``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.ops.fused_net_u import fused_mlp_u_z, fused_mlp_u_z_pallas
from dnnpde_tpu_torch.nets import MLP
from dnnpde_tpu_torch.ops.fused_net_u import FusedMlpUZ, make_fused_net_u, mlp_u_z
from dnnpde_tpu_torch.params import extract_mlp_params

B = 9


def _inputs(seed, layers, scale):
    rng = np.random.default_rng(seed)
    Ws = [(scale * rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(layers[:-1], layers[1:])]
    bs = [(0.1 * rng.normal(size=(b,))).astype(np.float32) for b in layers[1:]]
    x = rng.normal(size=(B, layers[0])).astype(np.float32)
    return Ws, bs, x


def _jax_grads(fn, Ws, bs, x):
    def scalar(Ws, bs, x):
        u, z = fn(Ws, bs, x)
        u2, z2 = fn(Ws, bs, x + 0.1 * z)  # feed Z back like the rollout does
        return jnp.sum(u2 * u) + jnp.sum(z2 * z)

    g = jax.grad(scalar, argnums=(0, 1, 2))(
        tuple(jnp.asarray(w) for w in Ws), tuple(jnp.asarray(b) for b in bs), jnp.asarray(x))
    return [np.asarray(a) for a in (*g[0], *g[1], g[2])]


def _port_grads(fn, Ws, bs, x):
    wb = [torch.from_numpy(a).requires_grad_(True) for a in (*Ws, *bs)]
    xt = torch.from_numpy(x).requires_grad_(True)
    L = len(Ws)
    u, z = fn(wb[:L], wb[L:], xt)
    u2, z2 = fn(wb[:L], wb[L:], (xt + 0.1 * z).contiguous())
    loss = torch.sum(u2 * u) + torch.sum(z2 * z)
    return [g.numpy() for g in torch.autograd.grad(loss, [*wb, xt])]


def test_fused_function_matches_pallas_interpret():
    # the Pallas kernels need hidden widths that are multiples of 128
    Ws, bs, x = _inputs(0, [5, 128, 128, 128, 1], 1.0)
    ref = _jax_grads(lambda W, b, x: fused_mlp_u_z_pallas(W, b, x, True), Ws, bs, x)
    got = _port_grads(lambda W, b, x: FusedMlpUZ.apply(x, *W, *b), Ws, bs, x)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        # bf16 dot operands on both sides, other summation orders (see
        # tests/test_torch_mlp_bwd.py): two-level tolerance on max|ref|
        d, scale = np.abs(a - r), np.abs(r).max()
        assert d.max() <= 1e-2 * scale and d.mean() <= 1e-4 * scale


@pytest.mark.parametrize("act", ["sine", "tanh", "relu"])
def test_torch_backend_grads_match_jax_fused(act):
    Ws, bs, x = _inputs(3, [5, 16, 16, 16, 1], 0.5 * np.sqrt(5))
    ref = _jax_grads(lambda W, b, x: fused_mlp_u_z(W, b, x, act), Ws, bs, x)
    got = _port_grads(lambda W, b, x: mlp_u_z(W, b, x, act), Ws, bs, x)
    for a, r in zip(got, ref):
        # f32 on both sides; the tolerance of tests/test_fused_net_u.py:62
        np.testing.assert_allclose(a, r, rtol=2e-4, atol=1e-6)


def test_cuda_backend_net_u_backpropagates_through_the_kernel_pair():
    """make_fused_net_u(..., "cuda") is differentiable: on CPU tensors its
    gradients are the plain K2's, close to the f32 "torch" backend's."""
    net = MLP([5, 32, 32, 1], "sine", generator=torch.Generator().manual_seed(0), device="cpu")
    t, X = torch.rand(6, 1), torch.randn(6, 4)
    grads = {}
    for backend in ("cuda", "torch"):
        u, Z = make_fused_net_u(net.layers, "sine", backend)(net, t, X)
        loss = (u**2).sum() + (Z**2).sum()
        grads[backend] = torch.autograd.grad(loss, list(net.parameters()))
    for a, r in zip(grads["cuda"], grads["torch"]):
        assert float((a - r).abs().max()) <= 2e-2 * float(r.abs().max())  # bf16 operands
    with pytest.raises(RuntimeError):  # first-order only, like the JAX custom VJP
        Ws, bs = extract_mlp_params(net)
        u, z = FusedMlpUZ.apply(torch.cat([t, X], 1).requires_grad_(True), *Ws, *bs)
        (g,) = torch.autograd.grad(z.sum(), Ws[0], create_graph=True)
        torch.autograd.grad(g.sum(), Ws[0])
