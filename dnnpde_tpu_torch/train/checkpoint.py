"""Checkpoints of the port: parameters, optimizer state, history and the
random stream, the counterpart of ``dnnpde_tpu/train/checkpoint.py``.

One ``torch.save`` file holds a dict of tensors, lists, tuples, dicts and
plain Python values, and is read back with ``torch.load(weights_only=True)``,
which unpickles nothing but those types, so restoring an untrusted
checkpoint cannot execute code (the JAX package keeps msgpack for the same
reason). Tensors are stored on the CPU.

:func:`save_checkpoint_orbax` / :func:`restore_checkpoint_orbax` write and
read a directory checkpoint of a nested dict (JAX's orbax checkpoints): the
tensors over ``torch.distributed.checkpoint``, which is sharding-aware (under
a process group every rank calls them, each writing and reading its own
shards of a sharded tensor; without a group they run in one process), and
the tree, with its plain values, in a JSON file beside them. DCP reads its
own ``.metadata`` file with ``pickle``, so restore only directories that
you wrote.
"""

from __future__ import annotations

import contextlib
import json
import warnings
from pathlib import Path
from typing import Any, Callable, Optional

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


@contextlib.contextmanager
def _one_process_ok():
    """Without a process group ``torch.distributed.checkpoint`` warns that it
    assumes one process, which is what is meant here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is .*")
        yield


_TREE = "tree.json"


def _describe(node: Any, key: str, tensors: dict) -> Any:
    """The JSON form of ``node``'s tree; its tensors go into ``tensors``
    under their path."""
    if isinstance(node, torch.Tensor):
        tensors[key] = node
        return {"tensor": key, "dtype": str(node.dtype).removeprefix("torch."),
                "shape": list(node.shape)}
    if isinstance(node, dict):
        return {"dict": {str(k): _describe(v, f"{key}.{k}", tensors) for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {type(node).__name__: [_describe(v, f"{key}.{i}", tensors)
                                      for i, v in enumerate(node)]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"a checkpoint holds tensors and plain values, not {type(node).__name__}")


def _build(desc: Any, tensor: Callable[[dict], Any]) -> Any:
    """The tree of a :func:`_describe` form, each tensor ``tensor(its
    form)``."""
    if "tensor" in desc:
        return tensor(desc)
    if "dict" in desc:
        return {k: _build(v, tensor) for k, v in desc["dict"].items()}
    if "list" in desc:
        return [_build(v, tensor) for v in desc["list"]]
    if "tuple" in desc:
        return tuple(_build(v, tensor) for v in desc["tuple"])
    return desc["value"]


def save_checkpoint_orbax(directory: str, state: Any) -> None:
    """Directory checkpoint of ``state``, a nested dict (lists and tuples
    too) of tensors and plain values, overwriting what the directory held."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = Path(directory).absolute()
    tensors: dict = {}
    tree = _describe(state, "state", tensors)
    with _one_process_ok():
        dcp.save(tensors, storage_writer=dcp.FileSystemWriter(path, overwrite=True))
    if not dist.is_initialized() or dist.get_rank() == 0:
        (path / _TREE).write_text(json.dumps(tree))


def restore_checkpoint_orbax(directory: str, template: Optional[Any] = None) -> Any:
    """The state saved in ``directory``: its tensors read into copies of the
    tensors of ``template`` (same structure; its tensors give shapes, dtypes,
    devices and shardings, and are left as they are), or, without a
    template, into new tensors on the CPU; its plain values as saved."""
    import torch.distributed.checkpoint as dcp

    path = Path(directory).absolute()
    tree = json.loads((path / _TREE).read_text())
    tensors: dict = {}
    if template is None:
        _build(tree, lambda d: tensors.setdefault(
            d["tensor"], torch.empty(d["shape"], dtype=getattr(torch, d["dtype"]))))
    else:
        _describe(template, "state", tensors)
        tensors = {k: torch.clone(v) for k, v in tensors.items()}
    with _one_process_ok():
        dcp.load(tensors, checkpoint_id=str(path))
    return _build(tree, lambda d: tensors[d["tensor"]])

