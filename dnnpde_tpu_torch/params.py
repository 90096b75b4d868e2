"""Weight interop between the port's :class:`~dnnpde_tpu_torch.nets.MLP` and
the JAX package's layout.

The JAX ``MLP`` parameter tree is ``params/Dense_k/Dense_0/{kernel,bias}``
with kernels of shape (in, out); ``nn.Linear.weight`` is (out, in). The
port's public functions take ``(Ws, bs)`` in the JAX layout, so tests and
kernels see the same arrays on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from dnnpde_tpu_torch.nets.networks import MLP


def _dense_names(tree) -> list[str]:
    return sorted(tree.keys(), key=lambda n: int(n.rsplit("_", 1)[1]))


def from_flax_params(
    tree, activation="sine", *, compute_dtype=None, device=None
) -> MLP:
    """A port ``MLP`` holding the weights of a JAX ``MLP`` parameter tree
    whose leaves are numpy arrays (``{"params": {"Dense_k": {"Dense_0":
    {"kernel", "bias"}}}}``)."""
    inner = tree["params"]
    names = _dense_names(inner)
    kernels = [np.array(inner[n]["Dense_0"]["kernel"], np.float32) for n in names]
    biases = [np.array(inner[n]["Dense_0"]["bias"], np.float32) for n in names]
    layers = [kernels[0].shape[0]] + [k.shape[1] for k in kernels]
    net = MLP(layers, activation, compute_dtype=compute_dtype, device=device)
    with torch.no_grad():
        for layer, k, b in zip(net.dense, kernels, biases):
            layer.linear.weight.copy_(torch.from_numpy(k.T.copy()))
            layer.linear.bias.copy_(torch.from_numpy(b))
    return net


def extract_mlp_params(module: MLP) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """(Ws, bs) in layer order, JAX layout: ``Ws[k]`` (in, out) contiguous,
    ``bs[k]`` (out,). The tensors stay on the module's device and in its
    autograd graph."""
    Ws = tuple(layer.linear.weight.t().contiguous() for layer in module.dense)
    bs = tuple(layer.linear.bias for layer in module.dense)
    return Ws, bs
