"""Named remat policies for the rollout step, the counterpart of
``jax.checkpoint_policies`` under ``SolverConfig(remat=True, remat_policy=...)``.

A policy names the ops of a rematerialized step whose outputs the forward
pass keeps; the backward pass's recompute takes those outputs from the cache
instead of computing them again, and recomputes the rest.

PyTorch's own selective checkpoint (``create_selective_checkpoint_contexts``)
hands each cached output out once. That fails on the autograd net_u: its
``torch.autograd.grad(..., create_graph=True)`` inside the step unpacks the
step's saved tensors during the forward pass, which recomputes the step
once there, and the backward pass recomputes it again. So the pair of
dispatch modes here keeps each cached output, keyed by (op, call index), for
every recompute of the step, and each recompute counts its calls from 0.
The forward mode records only: the op runs as it would without a policy, so
a policy changes no number. Ops outside ATen (the fused kernels K1 + K2 of
``fused_net_u="cuda"``, launched through ctypes) are not seen, so a policy
saves nothing inside them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_DOTS = frozenset({aten.mm.default, aten.addmm.default, aten.bmm.default})
_DOTS_NO_BATCH = frozenset({aten.mm.default, aten.addmm.default})


def _everything(func, args) -> bool:
    """Every op that computes a new tensor from tensors: not a view or an
    in-place op (whose output aliases an input), not a factory (no tensor
    input), and not ``detach``, which checkpoint itself calls a different
    number of times in the forward pass and the recompute."""
    if func is aten.detach.default:
        return False
    if any(r.alias_info is not None for r in func._schema.returns):
        return False
    return any(isinstance(a, torch.Tensor) for a in args)


# JAX's plain policies; its factory policies (``save_only_these_names``,
# ``offload_dot_with_no_batch_dims``, ``save_from_both_policies``, …) take
# arguments that SolverConfig cannot carry
POLICIES: dict[str, Optional[Callable]] = {
    "nothing_saveable": None,  # full remat
    "everything_saveable": _everything,
    "dots_saveable": lambda func, args: func in _DOTS,
    "checkpoint_dots": lambda func, args: func in _DOTS,
    "dots_with_no_batch_dims_saveable": lambda func, args: func in _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": lambda func, args: func in _DOTS_NO_BATCH,
}


def resolve_policy(name: Optional[str]) -> Optional[Callable]:
    """The save rule ``(func, args) -> bool`` of a policy name (None, and
    "nothing_saveable": save nothing, i.e. full remat)."""
    if name is None:
        return None
    if name not in POLICIES:
        raise ValueError(f"remat_policy {name!r} is not supported; supported: "
                         f"{sorted(POLICIES)} (JAX's factory policies take arguments "
                         "that SolverConfig cannot carry)")
    return POLICIES[name]


def _cached(entry):
    """A cached output, checked unchanged since the forward pass kept it."""
    tensor, version = entry
    if tensor._version != version:
        raise RuntimeError("a tensor kept by the remat policy was modified in place after "
                           "the forward pass; choose a policy that does not keep it")
    return tensor


class _Keep(TorchDispatchMode):
    """Forward pass: run every op and keep the outputs the policy names."""

    def __init__(self, policy: Callable, store: dict):
        super().__init__()
        self.policy, self.store, self.calls = policy, store, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.policy(func, args):
            i = self.calls.get(func, 0)
            self.calls[func] = i + 1
            self.store[(func, i)] = torch.utils._pytree.tree_map_only(
                torch.Tensor, lambda t: (t.detach(), t._version), out)
        return out


class _Reuse(TorchDispatchMode):
    """A recompute: hand out the kept outputs, run every other op."""

    def __init__(self, policy: Callable, store: dict):
        super().__init__()
        self.policy, self.store, self.calls = policy, store, {}

    def __enter__(self):
        self.calls = {}  # each recompute replays the step from its first op
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.policy(func, args):
            return func(*args, **(kwargs or {}))
        i = self.calls.get(func, 0)
        self.calls[func] = i + 1
        return torch.utils._pytree.tree_map(
            _cached, self.store[(func, i)],
            is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], torch.Tensor))


def policy_contexts(policy: Callable):
    """``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for a save
    rule: a fresh cache for each checkpointed call."""

    def context_fn():
        store: dict = {}
        return _Keep(policy, store), _Reuse(policy, store)

    return context_fn
