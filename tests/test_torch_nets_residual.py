"""The port's residual nets (ResNet, NaisNet, VerletNet) against Flax: weights
from a flax init carried across with ``from_flax_params``, the same inputs
made with numpy, u and Z = ∇ₓu within 1e-5 of max|·| and the parameter
gradients of Σu against ``jax.grad`` within 1e-5 of max|·| per tensor (f32
on both sides, other summation orders); bf16 hidden products at 2e-2 of
max|u|, as the MLP's test holds them."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.nets.networks import _nais_project as jax_nais_project
from dnnpde_tpu_torch.nets import NaisNet, ResNet, VerletNet, build_network
from dnnpde_tpu_torch.nets.networks import _nais_project
from dnnpde_tpu_torch.params import from_flax_params

LAYERS = [4, 16, 16, 16, 1]
B = 12
MODES = {"Resnet": ResNet, "Naisnet": NaisNet, "Verlet": VerletNet}


def _close(actual, reference, tol=1e-5):
    actual, reference = np.asarray(actual, np.float64), np.asarray(reference, np.float64)
    assert actual.shape == reference.shape
    assert np.abs(actual - reference).max() <= tol * (np.abs(reference).max() + 1e-30)


def _pair(mode, act, seed=1, compute_dtype=None):
    net = jax_build_network(mode, LAYERS, act, compute_dtype=compute_dtype)
    params = net.init(jax.random.PRNGKey(seed), jnp.ones((1, LAYERS[0])))
    port = from_flax_params(jax.tree.map(np.asarray, params), act, mode=mode,
                            compute_dtype=compute_dtype, device="cpu")
    return net, params, port


def _x(seed=3):
    return np.random.default_rng(seed).normal(size=(B, LAYERS[0])).astype(np.float32)


def _port_name(mode, n_blocks, keys):
    """The port parameter that holds the flax leaf at ``keys``, and whether
    it is stored transposed (``nn.Linear`` layout)."""
    name, leaf = keys[0], keys[-1]
    i = int(name.rsplit("_", 1)[1])
    if name.startswith("verlet_"):
        return f"{'kernels' if 'kernel' in name else 'biases'}.{i}", False
    if name.startswith("_StableBlockDense_"):
        return f"blocks.{i}.{'weight' if leaf == 'kernel' else 'bias'}", leaf == "kernel"
    last = 1 if mode == "Verlet" else n_blocks + 1
    module = ("inp" if i == 0 else "out" if i == last
              else f"{'inject' if mode == 'Naisnet' else 'blocks'}.{i - 1}")
    return f"{module}.linear.{'weight' if leaf == 'kernel' else 'bias'}", leaf == "kernel"


@pytest.mark.parametrize("act", ["Sine", "ReLU"])
@pytest.mark.parametrize("mode", list(MODES))
def test_u_z_and_parameter_gradients_match_flax(mode, act):
    net, params, port = _pair(mode, act)
    assert type(port) is MODES[mode]
    x = _x()

    def u_fn(p, xx):
        return net.apply(p, xx)

    u_ref = np.asarray(u_fn(params, x))
    z_ref = np.asarray(jax.grad(lambda xx: jnp.sum(u_fn(params, xx)))(jnp.asarray(x)))
    g_ref = jax.grad(lambda p: jnp.sum(u_fn(p, x)))(params)

    xt = torch.from_numpy(x).requires_grad_(True)
    u = port(xt)
    (z,) = torch.autograd.grad(u.sum(), xt, retain_graph=True)
    grads = dict(zip([n for n, _ in port.named_parameters()],
                     torch.autograd.grad(u.sum(), list(port.parameters()))))
    _close(u.detach().numpy(), u_ref)
    _close(z.numpy(), z_ref)

    n_blocks = len(LAYERS) - 3
    leaves = jax.tree_util.tree_flatten_with_path(g_ref["params"])[0]
    for path, g in leaves:
        name, transposed = _port_name(mode, n_blocks, [p.key for p in path])
        got = grads[name].numpy()
        _close(got.T if transposed else got, np.asarray(g))
    assert len(leaves) == len(grads)


@pytest.mark.parametrize("scale", [0.1, 3.0], ids=["below-clip", "above-clip"])
def test_nais_project_matches_jax(scale):
    rng = np.random.default_rng(7)
    kernel = (scale * rng.normal(size=(16, 16)) / 4).astype(np.float32)
    ref = np.asarray(jax_nais_project(jnp.asarray(kernel)))
    rtr_norm = np.linalg.norm(kernel @ kernel.T)
    assert (rtr_norm > 0.98) == (scale > 1)  # each case lies on its side of the clip
    # nn.Linear's weight is the transpose of the flax kernel
    got = _nais_project(torch.from_numpy(kernel.T.copy())).numpy()
    _close(got, ref)
    assert np.allclose(got, got.T, atol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_compute_dtype_matches_flax(mode):
    net, params, port = _pair(mode, "Sine", seed=4, compute_dtype="bfloat16")
    x = _x(5)
    ref = np.asarray(net.apply(params, x))
    out = port(torch.from_numpy(x)).detach()
    assert out.dtype == torch.float32  # the head stays f32
    _close(out.numpy(), ref, tol=2e-2)
    f32 = from_flax_params(jax.tree.map(np.asarray, params), "Sine", mode=mode, device="cpu")
    assert float((out - f32(torch.from_numpy(x)).detach()).abs().max()) > 0.0


def test_non_square_blocks_raise_as_in_jax():
    layers = [4, 16, 8, 1]
    with pytest.raises(ValueError, match="square"):
        jax_build_network("Naisnet", layers, "Sine").init(jax.random.PRNGKey(0),
                                                          jnp.ones((1, 4)))
    with pytest.raises(ValueError, match="square"):
        build_network("Naisnet", layers, "Sine", device="cpu")
    with pytest.raises(ValueError, match="uniform"):
        build_network("Verlet", layers, "Sine", device="cpu")


def test_build_network_spellings_and_generator():
    assert type(build_network("NAIS-Net", LAYERS, device="cpu")) is NaisNet
    res = build_network("Resnet", LAYERS, device="cpu")
    assert type(res) is ResNet and not res.stable and len(res.inject) == 0
    assert type(build_network("VerletNet", LAYERS, device="cpu")) is VerletNet
    with pytest.raises(ValueError, match="Unknown activation"):
        build_network("Naisnet", LAYERS, "gelu", device="cpu")
    a, b = (build_network("Naisnet", LAYERS, "Sine", generator=torch.Generator().manual_seed(0),
                          device="cpu") for _ in range(2))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    x = torch.from_numpy(_x())
    assert torch.equal(a(x), b(x))
