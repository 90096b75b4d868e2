"""The port's networks and weight interop against Flax: JAX-initialised
weights go through ``from_flax_params`` and both nets see the same inputs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnnpde_tpu.nets import build_network as jax_build_network
from dnnpde_tpu.nets.networks import MLP as JaxMLP
from dnnpde_tpu_torch.nets import (
    MLP,
    Dense,
    SDENet,
    build_network,
    get_activation,
    xavier_uniform,
)
from dnnpde_tpu_torch.params import extract_mlp_params, from_flax_params

LAYERS = [5, 32, 32, 1]
B = 16


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(2).normal(size=(B, LAYERS[0])).astype(np.float32)


@pytest.mark.parametrize("act", ["Sine", "Tanh", "ReLU"])
def test_mlp_matches_flax_f32(x, act):
    net = jax_build_network("FC", LAYERS, act)
    params = net.init(jax.random.PRNGKey(1), jnp.ones((1, LAYERS[0])))
    ref = np.asarray(net.apply(params, x))
    port = from_flax_params(_np_tree(params), act, device="cpu")
    out = port(torch.from_numpy(x)).detach().numpy()
    assert out.shape == (B, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)  # f32, other summation order


def test_mlp_bf16_compute_matches_flax_bf16(x):
    net = JaxMLP(layers=tuple(LAYERS), activation="sine", compute_dtype="bfloat16")
    params = net.init(jax.random.PRNGKey(4), jnp.ones((1, LAYERS[0])))
    ref = np.asarray(net.apply(params, x))
    port = from_flax_params(_np_tree(params), "sine", compute_dtype="bfloat16", device="cpu")
    out = port(torch.from_numpy(x)).detach()
    assert out.dtype == torch.float32  # the head stays f32
    f32 = from_flax_params(_np_tree(params), "sine", device="cpu")(torch.from_numpy(x)).detach()
    scale = float(np.abs(ref).max())
    # bf16 hidden layers: ~2^-8 relative per value, averaged over the head
    np.testing.assert_allclose(out.numpy() / scale, ref / scale, rtol=0, atol=2e-2)
    assert float((out - f32).abs().max()) > 0.0  # the hidden dtype really is bf16


def test_extract_mlp_params_gives_the_jax_layout():
    net = jax_build_network("FC", LAYERS, "Sine")
    params = _np_tree(net.init(jax.random.PRNGKey(0), jnp.ones((1, LAYERS[0]))))
    Ws, bs = extract_mlp_params(from_flax_params(params, device="cpu"))
    for k, (W, b) in enumerate(zip(Ws, bs)):
        inner = params["params"][f"Dense_{k}"]["Dense_0"]
        np.testing.assert_array_equal(W.detach().numpy(), inner["kernel"])
        np.testing.assert_array_equal(b.detach().numpy(), inner["bias"])
        assert W.is_contiguous() and W.shape == (LAYERS[k], LAYERS[k + 1])


def test_mlp_structure_and_generator_determinism():
    a = MLP(LAYERS, "Sine", generator=torch.Generator().manual_seed(3), device="cpu")
    b = MLP(LAYERS, "Sine", generator=torch.Generator().manual_seed(3), device="cpu")
    c = MLP(LAYERS, "Sine", generator=torch.Generator().manual_seed(4), device="cpu")
    assert a.layers == tuple(LAYERS) and len(a.dense) == len(LAYERS) - 1
    for la, lb in zip(a.dense, b.dense):
        assert torch.equal(la.linear.weight, lb.linear.weight)
        assert torch.count_nonzero(la.linear.bias) == 0
    assert not torch.equal(a.dense[0].linear.weight, c.dense[0].linear.weight)


def test_xavier_uniform_bound_and_variance():
    init = xavier_uniform(gain=0.5)
    w = init((300, 200), torch.Generator().manual_seed(0))
    bound = 0.5 * (6.0 / 500) ** 0.5
    assert w.shape == (300, 200) and float(w.abs().max()) <= bound
    # uniform on [-a, a]: variance a²/3; 6e4 draws give ~0.6% standard error
    assert abs(float(w.var()) / (bound**2 / 3) - 1.0) < 0.03
    with pytest.raises(ValueError, match=">=2D"):
        init((5,))


def test_dense_is_xavier_in_jax_layout():
    d = Dense(4, 6, gain=2.0, generator=torch.Generator().manual_seed(0), device="cpu")
    assert d.linear.weight.shape == (6, 4)
    assert float(d.linear.weight.detach().abs().max()) <= 2.0 * (6.0 / 10) ** 0.5


def test_activations():
    x = torch.linspace(-2, 2, 9)
    assert torch.equal(get_activation("Sine")(x), torch.sin(x))
    assert torch.equal(get_activation("ReLU")(x), torch.clamp(x, min=0))
    assert torch.equal(get_activation("tanh")(x), torch.tanh(x))
    assert get_activation(torch.cos) is torch.cos
    with pytest.raises(ValueError, match="Unknown activation"):
        get_activation("gelu")


def test_build_network_modes():
    net = build_network("FC", LAYERS, "Sine", device="cpu")
    assert isinstance(net, MLP)
    assert isinstance(build_network("mlp", LAYERS, device="cpu"), MLP)
    sde = build_network("SDEnet", LAYERS, device="cpu", h=0.2)
    assert isinstance(sde, SDENet) and sde.h == 0.2 and not sde.deterministic
    with pytest.raises(ValueError, match="Unknown network mode"):
        build_network("transformer", LAYERS, device="cpu")
