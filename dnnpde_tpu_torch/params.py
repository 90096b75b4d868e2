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
``verlet_kernel_i``/``verlet_bias_i`` directly. An ``SDENet`` holds
``Dense_0`` (input), ``Dense_1`` ... ``Dense_n`` (the blocks), ``Dense_{n+1}``
(head) and ``brownian_kernel_i`` (width, 1) directly.
"""

from __future__ import annotations

import numpy as np
import torch

from dnnpde_tpu_torch.nets.networks import (
    MLP, Dense, NaisNet, ResNet, SDENet, VerletNet, _nais_project,
)


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
    tree, activation="sine", *, mode: str = "FC", compute_dtype=None, device=None,
    **net_kwargs,
) -> torch.nn.Module:
    """A port net holding the weights of a JAX parameter tree whose leaves are
    numpy arrays (``{"params": {...}}``): an ``MLP`` for ``mode`` "FC"; for
    a ``ResNet``/``NaisNet``/``VerletNet`` tree (``mode`` "Resnet",
    "Naisnet" or "Verlet"; a tree with ``_StableBlockDense_*`` or
    ``verlet_kernel_*`` leaves is read as NAIS-Net or Verlet whatever
    ``mode`` says) the matching residual net; for an ``SDENet`` tree
    (``brownian_kernel_*`` leaves) an SDENet, with ``net_kwargs`` (``h``,
    ``eps``, ``deterministic``) passed to it."""
    inner = tree["params"]
    names = _dense_names(inner)
    key = mode.lower()
    if any(n.startswith("_StableBlockDense_") for n in inner):
        key = "naisnet"
    elif any(n.startswith("verlet_kernel_") for n in inner):
        key = "verlet"
    elif any(n.startswith("brownian_kernel_") for n in inner):
        key = "sdenet"
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
    if key == "sdenet":
        n_blocks = sum(n.startswith("brownian_kernel_") for n in inner)
        net = SDENet([shapes[0][0]] + [s[1] for s in shapes], activation, **kw, **net_kwargs)
        with torch.no_grad():
            _set_dense(net.inp, inner[names[0]])
            _set_dense(net.out, inner[names[-1]])
            for i in range(n_blocks):
                _set_dense(net.blocks[i], inner[names[i + 1]])
                net.brownian[i].copy_(_f32(inner[f"brownian_kernel_{i}"]))
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


def _replica_slice(tree, k: int):
    if isinstance(tree, dict):
        return {n: _replica_slice(v, k) for n, v in tree.items()}
    return np.asarray(tree)[k]


def from_flax_replicas(tree, activation="sine", *, mode: str = "FC", compute_dtype=None,
                       device=None, **net_kwargs) -> dict:
    """A replica-stacked JAX parameter tree (``{"params": {...}}`` with
    leaves (K, …), as ``jax.vmap`` of ``net.init`` makes it) as the port's
    stacked state: parameter name → (K, …) tensor, the layout of
    ``torch.func.stack_module_state`` that ``train/replicas.py`` trains.
    Replica k is ``from_flax_params`` of the tree's k-th slice."""
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    nets = [from_flax_params(_replica_slice(tree, k), activation, mode=mode,
                             compute_dtype=compute_dtype, device=device, **net_kwargs)
            for k in range(np.shape(first)[0])]
    stacked, _ = torch.func.stack_module_state(nets)
    return {n: p.detach() for n, p in stacked.items()}


def extract_mlp_params(module: MLP) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """(Ws, bs) in layer order, JAX layout: ``Ws[k]`` (in, out) contiguous,
    ``bs[k]`` (out,). The tensors stay on the module's device and in its
    autograd graph."""
    Ws = tuple(layer.linear.weight.t().contiguous() for layer in module.dense)
    bs = tuple(layer.linear.bias for layer in module.dense)
    return Ws, bs


def extract_nais_params(module: ResNet) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """A NAIS-Net's (Ws, bs) in the layout of the fused path's kernels
    (``ops/mlp_kernel.py``): the input layer (n0, H), each block's
    ``[U_i; 0; -A_i]`` (round16(n0) + H, H) with ``A_i`` the stability
    projection of its weight (``nets.networks._nais_project``, f32) and
    ``U_i`` its input injection, bias ``b_i + c_i``; then the head (H, 1).
    The tensors stay on the module's device and in its autograd graph, so
    one call per loss differentiates through the projections once."""
    from dnnpde_tpu_torch.ops.mlp_kernel import nais_block_weight

    Ws = [module.inp.linear.weight.t().contiguous()]
    bs = [module.inp.linear.bias]
    for block, inject in zip(module.blocks, module.inject):
        Ws.append(nais_block_weight(inject.linear.weight.t(), -_nais_project(block.weight)))
        bs.append(block.bias + inject.linear.bias)
    Ws.append(module.out.linear.weight.t().contiguous())
    bs.append(module.out.linear.bias)
    return tuple(Ws), tuple(bs)
