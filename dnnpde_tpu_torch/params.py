"""Weight interop between the port's nets and the JAX package's layout.

The JAX ``MLP`` parameter tree is ``params/Dense_k/Dense_0/{kernel,bias}``
with kernels of shape (in, out); ``nn.Linear.weight`` is (out, in). The
port's public functions take ``(Ws, bs)`` in the JAX layout, so tests and
kernels see the same arrays on both sides.

Flax names a net's layers by their order of creation, per class. In a
``ResNet``/``NaisNet``, ``Dense_0`` is the input layer, ``Dense_1`` ...
``Dense_n`` are the n blocks' plain layers (``stable=False``) or their input
injections (``stable=True``, beside ``_StableBlockDense_0`` ...
``_StableBlockDense_{n-1}``), and ``Dense_{n+1}`` is the head. A
``VerletNet`` holds ``Dense_0`` (input), ``Dense_1`` (head) and
``verlet_kernel_i``/``verlet_bias_i`` directly.
"""

from __future__ import annotations

import numpy as np
import torch

from dnnpde_tpu_torch.nets.networks import MLP, Dense, NaisNet, ResNet, VerletNet


def _index(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def _dense_names(tree) -> list[str]:
    return sorted((n for n in tree if n.startswith("Dense_")), key=_index)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _set_dense(layer: Dense, leaf) -> None:
    layer.linear.weight.copy_(_f32(leaf["Dense_0"]["kernel"]).T)
    layer.linear.bias.copy_(_f32(leaf["Dense_0"]["bias"]))


def from_flax_params(
    tree, activation="sine", *, mode: str = "FC", compute_dtype=None, device=None
) -> torch.nn.Module:
    """A port net holding the weights of a JAX parameter tree whose leaves are
    numpy arrays (``{"params": {...}}``): an ``MLP`` for ``mode`` "FC"; for
    a ``ResNet``/``NaisNet``/``VerletNet`` tree (``mode`` "Resnet",
    "Naisnet" or "Verlet"; a tree with ``_StableBlockDense_*`` or
    ``verlet_kernel_*`` leaves is read as NAIS-Net or Verlet whatever
    ``mode`` says) the matching residual net."""
    inner = tree["params"]
    names = _dense_names(inner)
    key = mode.lower()
    if any(n.startswith("_StableBlockDense_") for n in inner):
        key = "naisnet"
    elif any(n.startswith("verlet_kernel_") for n in inner):
        key = "verlet"
    kw = dict(compute_dtype=compute_dtype, device=device)
    shapes = [np.shape(inner[n]["Dense_0"]["kernel"]) for n in names]
    if key in ("fc", "mlp"):
        net = MLP([shapes[0][0]] + [s[1] for s in shapes], activation, **kw)
        with torch.no_grad():
            for layer, n in zip(net.dense, names):
                _set_dense(layer, inner[n])
        return net
    if key == "verlet":
        n_blocks = sum(n.startswith("verlet_kernel_") for n in inner)
        width = shapes[0][1]
        net = VerletNet([shapes[0][0]] + [width] * (n_blocks + 1) + [shapes[-1][1]],
                        activation, **kw)
        with torch.no_grad():
            _set_dense(net.inp, inner[names[0]])
            _set_dense(net.out, inner[names[-1]])
            for i in range(n_blocks):
                net.kernels[i].copy_(_f32(inner[f"verlet_kernel_{i}"]))
                net.biases[i].copy_(_f32(inner[f"verlet_bias_{i}"]))
        return net
    if key not in ("naisnet", "nais-net", "resnet"):
        raise ValueError(f"cannot read a {mode!r} parameter tree")
    stable = key != "resnet"
    widths = [s[1] for s in shapes[:-1]]  # input layer, then each block (or its injection)
    net = (NaisNet if stable else ResNet)(
        [shapes[0][0]] + widths + [shapes[-1][1]], stable=stable, activation=activation, **kw)
    with torch.no_grad():
        _set_dense(net.inp, inner[names[0]])
        _set_dense(net.out, inner[names[-1]])
        for i in range(len(net.blocks)):
            if stable:
                _set_dense(net.inject[i], inner[names[i + 1]])
                leaf = inner[f"_StableBlockDense_{i}"]
                net.blocks[i].weight.copy_(_f32(leaf["kernel"]).T)
                net.blocks[i].bias.copy_(_f32(leaf["bias"]))
            else:
                _set_dense(net.blocks[i], inner[names[i + 1]])
    return net


def extract_mlp_params(module: MLP) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """(Ws, bs) in layer order, JAX layout: ``Ws[k]`` (in, out) contiguous,
    ``bs[k]`` (out,). The tensors stay on the module's device and in its
    autograd graph."""
    Ws = tuple(layer.linear.weight.t().contiguous() for layer in module.dense)
    bs = tuple(layer.linear.bias for layer in module.dense)
    return Ws, bs
