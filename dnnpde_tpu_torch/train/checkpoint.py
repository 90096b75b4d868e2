"""Checkpoints of the port: parameters, optimizer state, history and the
random stream, the counterpart of ``dnnpde_tpu/train/checkpoint.py``.

One ``torch.save`` file holds a dict of tensors, lists, tuples, dicts and
plain Python values, and is read back with ``torch.load(weights_only=True)``,
which unpickles nothing but those types, so restoring an untrusted
checkpoint cannot execute code (the JAX package keeps msgpack for the same
reason). Tensors are stored on the CPU.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import torch


def _to_cpu(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, (list, tuple)):
        return [_to_cpu(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_cpu(x) for k, x in v.items()}
    return v


def save_checkpoint(file_name: str, params: Any, opt_state: Any = None, **metadata: Any) -> None:
    """Write params (a state dict), the optional optimizer state and
    metadata (tensors, numbers, strings and nested lists or dicts of them)."""
    payload = {
        "params": _to_cpu(params),
        "opt_state": _to_cpu(opt_state),
        "metadata": {k: _to_cpu(v) for k, v in metadata.items()},
    }
    Path(file_name).parent.mkdir(parents=True, exist_ok=True)
    torch.save(payload, file_name)


def restore_checkpoint(file_name: str) -> dict[str, Any]:
    """A dict with ``params``, ``opt_state`` (or None) and every saved
    metadata key; tensors on the CPU."""
    payload = torch.load(file_name, map_location="cpu", weights_only=True)
    out = dict(payload["metadata"])
    out["params"] = payload["params"]
    out["opt_state"] = payload["opt_state"]
    return out
