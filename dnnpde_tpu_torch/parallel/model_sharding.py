"""Tensor parallelism over a model axis "tp", the counterpart of
``dnnpde_tpu/parallel/model_sharding.py``.

The plan is JAX's: walk the net's 2-D weights in forward (creation) order
and alternate column-parallel and row-parallel, advancing the phase only
when a weight actually shards; dims below ``min_shard_dim`` stay
replicated. ``nn.Linear.weight`` (and the NAIS-Net block's weight) is the
flax kernel transposed, so JAX's column-parallel ``P(None, "tp")`` is the
port's ``Shard(0)`` there and row-parallel ``P("tp", None)`` is
``Shard(1)``; the Verlet and SDENet kernels are stored in JAX's layout and
keep its dims. For the plain ``MLP`` the creation order is JAX's natural
name order, so the two plans agree name for name.

Each rank holds only its shard of a sharded weight. How the net computes
with the shards:

- In an ``MLP``, a column-parallel layer followed by a row-parallel one is
  Megatron's pair: ``f`` (identity forward, all-reduce backward) before the
  column layer, whose bias is sliced with its weight, and ``g`` (all-reduce
  forward, identity backward) after the row layer, whose bias is added once
  after the sum. Each is a ``torch.autograd.Function`` whose backward is
  the other, so Z = ∇ₓu and the loss's gradient through Z (a double
  backward) both cross the collectives correctly.
- Any other sharded weight (the residual nets' and SDENet's, which JAX
  shards by the same plan) is gathered whole before use: one all-reduce of
  a zero-filled buffer forward, this rank's slice of the gradient backward
  (the loss is the same on every rank of "tp", so its gradient is too).

Batch stays on "dp"; :func:`make_mesh_2d` lays the ranks out (dp, tp) in
rank order. Checkpoints hold the full weights (:func:`full_state_dict`).
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.utils import parametrize

from dnnpde_tpu_torch.nets.networks import MLP
from dnnpde_tpu_torch.parallel.distributed import all_reduce, gather_rows
from dnnpde_tpu_torch.parallel.mesh import DP_AXIS, world_mesh

TP_AXIS = "tp"


def make_mesh_2d(dp: int, tp: int, devices=None) -> DeviceMesh:
    """(dp × tp) mesh over the group's dp·tp ranks: rank = d·tp + t.
    ``devices`` as in ``make_mesh``."""
    return world_mesh((int(dp), int(tp)), (DP_AXIS, TP_AXIS), devices)


def _clean(name: str) -> str:
    """A parameter's name as the unsharded net has it (a gathered weight
    lives under ``parametrizations.<name>.original``)."""
    return re.sub(r"parametrizations\.([^.]+)\.original$", r"\1", name)


def _named_tensors(params: Any) -> list[tuple[str, torch.Tensor]]:
    if isinstance(params, nn.Module):
        return [(_clean(n), p) for n, p in params.named_parameters()]
    return list(params.items())


def _jax_layout(name: str) -> bool:
    """Whether the port stores this 2-D weight as the flax kernel (in, out)
    rather than transposed (``nn.Linear.weight``, the NAIS-Net block)."""
    return not name.endswith("weight")


def plan_tp_specs(params: Any, min_shard_dim: int = 512) -> dict[tuple, Any]:
    """Alternating column/row plan of a net's 2-D weights, keyed by their
    name split at the dots: ``Shard(d)`` for the dim of the port's tensor
    that shards, ``Replicate()`` for the rest. ``params`` is a module or a
    name → tensor mapping (a state dict), in forward order."""
    from torch.distributed.tensor import Replicate, Shard  # imports sympy: ~1 s

    specs: dict[tuple, Any] = {}
    k = 0
    for name, leaf in _named_tensors(params):
        if leaf.ndim != 2:
            continue
        jax_layout = _jax_layout(name)
        n_in, n_out = leaf.shape if jax_layout else leaf.shape[::-1]
        spec = Replicate()
        if k % 2 == 0 and n_out >= min_shard_dim:  # column parallel
            spec = Shard(1 if jax_layout else 0)
            k += 1
        elif k % 2 == 1 and n_in >= min_shard_dim:  # row parallel
            spec = Shard(0 if jax_layout else 1)
            k += 1
        specs[tuple(name.split("."))] = spec
    return specs


class _Group:
    """A process group held by a module; deep copies as itself, so that the
    EMA shadow (a deep copy of the net) shares it."""

    def __init__(self, pg):
        self.pg = pg

    def __deepcopy__(self, memo):
        return self


class _CopyToTP(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce over "tp" backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromTP.apply(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's ``g``: all-reduce over "tp" forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group.pg)

    @staticmethod
    def backward(ctx, grad):
        return _CopyToTP.apply(grad, ctx.group), None


class _GatherTP(torch.autograd.Function):
    """A weight's shards gathered whole along ``dim``; the backward keeps
    this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, shard, dim, size, group):
        ctx.dim, ctx.n = dim, shard.shape[dim]
        ctx.offset = dist.get_rank(group.pg) * ctx.n
        return gather_rows(shard, size, group.pg, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.offset, ctx.n), None, None, None


class _Gathered(nn.Module):
    """Parametrization: the stored tensor is this rank's shard, the module
    sees the whole weight."""

    def __init__(self, dim: int, size: int, group: _Group):
        super().__init__()
        self.dim, self.size, self.group = dim, size, group

    def forward(self, shard):
        return _GatherTP.apply(shard, self.dim, self.size, self.group)

    def right_inverse(self, full):
        return _slice(full, self.dim, self.group).clone()


class _ParallelDense(nn.Module):
    """An MLP layer of a Megatron pair (``kind`` "col" or "row") holding its
    shards in ``linear``, as ``Dense`` holds its weights."""

    def __init__(self, dense: nn.Module, kind: str, group: _Group):
        super().__init__()
        self.dtype, self.kind, self.group = dense.dtype, kind, group
        self.linear = dense.linear

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.linear.weight, self.linear.bias
        if self.kind == "col":
            x = _CopyToTP.apply(x, self.group)
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        if self.kind == "col":
            return F.linear(x, w, b)
        return _ReduceFromTP.apply(F.linear(x, w), self.group) + b


def _slice(full: torch.Tensor, dim: int, group: _Group) -> torch.Tensor:
    n = full.shape[dim] // dist.get_world_size(group.pg)
    return full.narrow(dim, dist.get_rank(group.pg) * n, n)


def shard_params_tp(params: nn.Module, mesh: DeviceMesh, min_shard_dim: int = 512) -> nn.Module:
    """Shard ``params`` (a net) over the mesh's "tp" dim in place, by
    :func:`plan_tp_specs`; returns it. Layers narrower than
    ``min_shard_dim`` stay replicated. A sharded dim must divide by the
    "tp" size."""
    net = params
    group = _Group(mesh.get_group(TP_AXIS))
    tp = mesh.size(mesh.mesh_dim_names.index(TP_AXIS))
    plan = {".".join(k): v for k, v in plan_tp_specs(net, min_shard_dim).items()
            if v.is_shard()}
    for name, spec in plan.items():
        size = dict(net.named_parameters())[name].shape[spec.dim]
        if size % tp:
            raise ValueError(f"{name}: dim {spec.dim} of size {size} does not divide by tp={tp}")
    # Megatron's pairs: in an MLP the alternating plan follows a column layer
    # by a row layer; any other sharded weight is gathered before use
    pairs: dict[str, str] = {}
    if type(net) is MLP:
        for k in range(len(net.dense) - 1):
            col = plan.get(f"dense.{k}.linear.weight")
            row = plan.get(f"dense.{k + 1}.linear.weight")
            if col is not None and col.dim == 0 and row is not None and row.dim == 1:
                pairs[f"dense.{k}.linear.weight"] = "col"
                pairs[f"dense.{k + 1}.linear.weight"] = "row"
    with torch.no_grad():
        for name, spec in plan.items():
            path, _, attr = name.rpartition(".")
            owner = net.get_submodule(path)
            full = getattr(owner, attr)
            if name in pairs:
                k = int(name.split(".")[1])
                owner.weight = nn.Parameter(_slice(full, spec.dim, group).clone())
                if pairs[name] == "col":
                    owner.bias = nn.Parameter(_slice(owner.bias, 0, group).clone())
                net.dense[k] = _ParallelDense(net.dense[k], pairs[name], group)
            else:
                parametrize.register_parametrization(
                    owner, attr, _Gathered(spec.dim, full.shape[spec.dim], group), unsafe=True)
    dims = {name: spec.dim for name, spec in plan.items()}
    for name, kind in pairs.items():  # a column layer's bias is sliced with its weight
        if kind == "col":
            dims[name[: -len("weight")] + "bias"] = 0
    net.tp_dims, net.tp_group = dims, group
    return net


def shard_dims(net: nn.Module) -> list[Optional[int]]:
    """The dim along which each of ``net.parameters()`` is a shard of the
    full tensor (None: replicated), in their order."""
    dims = getattr(net, "tp_dims", {})
    return [dims.get(_clean(n)) for n, _ in net.named_parameters()]


def gather_full(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
                net: nn.Module) -> list[torch.Tensor]:
    """The full tensors of ``tensors`` (shards along ``dims``, None for a
    replicated one) on every rank of the net's "tp" group."""
    group = getattr(net, "tp_group", None)
    return [t.detach() if d is None else
            gather_rows(t.detach(), t.shape[d] * dist.get_world_size(group.pg), group.pg, d)
            for t, d in zip(tensors, dims)]


def slice_full(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
               net: nn.Module) -> list[torch.Tensor]:
    """This rank's shards of the full ``tensors``: the inverse of
    :func:`gather_full`."""
    group = getattr(net, "tp_group", None)
    return [t if d is None else _slice(t, d, group) for t, d in zip(tensors, dims)]


def full_state_dict(net: nn.Module) -> dict[str, torch.Tensor]:
    """The net's parameters, gathered whole, under the unsharded net's
    names (a collective over "tp": every rank calls it)."""
    names = [_clean(n) for n, _ in net.named_parameters()]
    return dict(zip(names, gather_full(list(net.parameters()), shard_dims(net), net)))


def load_full_state_dict(net: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Copy full tensors (a :func:`full_state_dict`) into the net's
    shards."""
    with torch.no_grad():
        names = [_clean(n) for n, _ in net.named_parameters()]
        shards = slice_full([state[n] for n in names], shard_dims(net), net)
        for p, s in zip(net.parameters(), shards):
            p.copy_(s)


def tp_sharding_summary(params: nn.Module) -> dict[str, str]:
    """The placement of every parameter of a net, by name (for tests and
    logs)."""
    dims = getattr(params, "tp_dims", {})
    return {_clean(n): f"Shard(dim={dims[_clean(n)]})" if _clean(n) in dims else "Replicate()"
            for n, _ in params.named_parameters()}
