"""Export and load a learned solution ``(t, X) → (u, Z = ∇ₓu)``, the
counterpart of ``dnnpde_tpu/serve/export.py``.

What is exported is the solution function, not the model: one
``torch.export`` program ``(t (b, 1), X (b, D)) → (u (b, 1), Z (b, D))`` with

- the trained weights baked in (a self-contained artifact: serving imports
  none of the port's nets, problems or solver, and builds no model),
- a dynamic batch dimension (``torch.export.Dim``), so one artifact serves
  any batch,
- Z = ∇ₓu computed inside the program in f32: the reverse pass through
  ``transform_u ∘ net`` is traced into plain ATen ops (``make_fx``, the
  weights passed as inputs), the same ``make_net_u`` semantics as training,
  so the greeks ship with the price.

Every net is covered, behind any output transform; a stochastic net
(``SDENet``) is served under its fixed evaluation noise, which the program
computes for the batch it is given. The file is ``torch.export.save``'s
archive with one JSON record of what it serves (dim, net, problem).
:func:`load_solution` refuses an archive that holds pickled objects, so
loading unpickles nothing but tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import itertools
import json
import zipfile
from typing import Any

import numpy as np
import torch

from dnnpde_tpu_torch import tracing
from dnnpde_tpu_torch.runtime import default_device

Tensor = torch.Tensor

_RECORD = "dnnpde_solution.json"
_MODES = {"MLP": "FC", "NaisNet": "Naisnet", "ResNet": "Resnet", "VerletNet": "Verlet",
          "SDENet": "SDEnet"}


class _Solution(torch.nn.Module):
    """``make_net_u(net, transform)`` as a module, for tracing with the
    weights swapped for inputs (``torch.func.functional_call``)."""

    def __init__(self, net: torch.nn.Module, transform):
        from dnnpde_tpu_torch.solver.bsde import make_net_u

        super().__init__()
        self.net = net
        self.net_u = make_net_u(net, transform)

    def forward(self, t: Tensor, X: Tensor):
        with torch.no_grad():
            return self.net_u(t, X)


class _Baked(torch.nn.Module):
    """The traced solution with its weights as buffers: what is exported."""

    def __init__(self, graph: torch.nn.Module, weights: list[Tensor]):
        super().__init__()
        self.graph = graph
        for i, w in enumerate(weights):
            self.register_buffer(f"w{i}", w)
        self.n = len(weights)

    def forward(self, t: Tensor, X: Tensor):
        return self.graph(t, X, *(getattr(self, f"w{i}") for i in range(self.n)))


def export_solution(net: torch.nn.Module, dim: int, transform=None,
                    stochastic: bool = False) -> bytes:
    """The artifact of ``net``'s solution for a ``dim``-dimensional state,
    as bytes. ``transform``: the problem's output parametrization
    ``(t, X, raw) → u`` (pass ``problem.transform_u``), or None.
    ``stochastic`` is accepted for the JAX signature: an ``SDENet`` is always
    served under its fixed evaluation noise."""
    with tracing.span("dnnpde.serve.export"):
        return _export(net, dim, transform)


def _export(net: torch.nn.Module, dim: int, transform) -> bytes:
    from torch.fx.experimental.proxy_tensor import make_fx

    layers = getattr(net, "layers", None)
    if layers is not None and (layers[0] != dim + 1 or layers[-1] != 1):
        raise ValueError(f"net layers {list(layers)} do not map [t, X] ({dim + 1}) to u (1)")
    module = _Solution(net, transform)
    named = dict(module.named_parameters())
    named.update(module.named_buffers())
    names = list(named)
    weights = [v.detach().to("cpu", torch.float32, copy=True) for v in named.values()]

    def solution(t: Tensor, X: Tensor, *tensors: Tensor):
        return torch.func.functional_call(module, dict(zip(names, tensors)), (t, X))

    example = (torch.full((7, 1), 0.5), torch.ones(7, dim))
    graph = make_fx(solution, tracing_mode="symbolic")(*example, *weights)
    u, Z = graph(*example, *weights)
    if u.shape != (7, 1) or Z.shape != (7, dim):
        raise ValueError(f"{type(net).__name__} does not map [t, X] ({dim + 1}) to u (1)")
    batch = torch.export.Dim("b", min=1)
    program = torch.export.export(_Baked(graph, weights), example,
                                  dynamic_shapes=({0: batch}, {0: batch}), strict=False)
    owner = getattr(transform, "__self__", None)  # the problem of a bound transform_u
    record = {
        "dim": int(dim),
        "mode": _MODES.get(type(net).__name__, type(net).__name__),
        "layers": None if layers is None else [int(w) for w in layers],
        "activation": None if layers is None else str(net.activation).lower(),
        "problem": None if owner is None else type(owner).__name__,
    }
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_RECORD: json.dumps(record)})
    return buf.getvalue()


def export_trainer(trainer, use_ema: bool = False) -> bytes:
    """The artifact of a :class:`~dnnpde_tpu_torch.train.Trainer`'s current
    solution; ``use_ema=True`` bakes the EMA shadow (needs ``ema_decay``)."""
    problem = trainer.problem
    return export_solution(
        trainer.ema_params if use_ema else trainer.params, problem.dim,
        transform=problem.transform_u if problem.has_output_transform else None,
        stochastic=bool(trainer.config.stochastic_net),
    )


def save_solution(path: str, *args, **kwargs) -> None:
    """:func:`export_solution` (or, given a Trainer, :func:`export_trainer`)
    to a file: ``save_solution(path, net, dim, transform=...)`` or
    ``save_solution(path, trainer, use_ema=...)``."""
    if args and hasattr(args[0], "problem"):  # a Trainer
        blob = export_trainer(*args, **kwargs)
    else:
        blob = export_solution(*args, **kwargs)
    with open(path, "wb") as f:
        f.write(blob)


@dataclasses.dataclass(frozen=True)
class ServedSolution:
    """A loaded solution artifact: u and ∇ₓu at any (t, X) batch on
    ``device``. ``program`` is the ``torch.export.ExportedProgram``;
    ``record`` says what it serves (``dim``, ``mode``, ``layers``,
    ``activation``, ``problem``: the output transform's problem class, or
    None)."""

    program: torch.export.ExportedProgram
    record: dict
    device: torch.device
    # the number of the next request, kept with its spans
    _requests: itertools.count = dataclasses.field(default_factory=itertools.count,
                                                   init=False, repr=False, compare=False)

    @property
    def dim(self) -> int:
        return int(self.record["dim"])

    @functools.cached_property
    def _call(self):
        """``(t, X) -> (u, Z)``: the program's graph with its weights bound,
        the ops that read the weights only (their transposes) and the reverse
        pass's constant seed made once, at load, and its detaches and dead
        ops dropped. ``program.module()`` would check each request's shapes
        against the program's symbolic constraints and flatten its inputs
        first, which doubles the host time of a request;
        ``u_and_grad_device`` shapes the request itself."""
        with tracing.span("dnnpde.serve.fold"):
            return self._fold()

    def _fold(self):
        from torch.export.graph_signature import InputKind

        program = self.program
        graph, env, known, consts = torch.fx.Graph(), {}, {}, {}
        specs = iter(program.graph_signature.input_specs)
        for node in program.graph_module.graph.nodes:
            if node.op == "placeholder":
                spec = next(specs)
                if spec.kind == InputKind.USER_INPUT:
                    env[node] = graph.placeholder(node.name)
                elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER):
                    known[node] = (program.state_dict[spec.target] if spec.persistent is not False
                                   else program.constants[spec.target])
                elif spec.kind == InputKind.CONSTANT_TENSOR:
                    known[node] = program.constants[spec.target]
                else:
                    raise ValueError(f"the artifact's program takes a {spec.kind} input")
            elif (node.op == "call_function" and node.all_input_nodes
                  and all(a in known for a in node.all_input_nodes)):
                args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs), known.get)
                known[node] = node.target(*args, **kwargs)
            elif node.target is torch.ops.aten.detach.default:  # a no-op without autograd
                env[node] = env[node.args[0]]
            elif node.target in _FILLS and _static(node.args[0]):
                # the reverse pass's seed: its value depends on no request
                val = node.args[0].meta["val"]
                stand_in = torch.empty(val.shape, dtype=val.dtype, device=self.device)
                known[node] = node.target(stand_in, *node.args[1:], **node.kwargs)
            else:
                for a in node.all_input_nodes:
                    if a in known and a not in env:
                        consts[f"_c{len(consts)}"] = known[a]
                        env[a] = graph.get_attr(f"_c{len(consts) - 1}")
                env[node] = graph.node_copy(node, env.__getitem__)
        graph.eliminate_dead_code()
        root = torch.nn.Module()
        for name, value in consts.items():
            setattr(root, name, value)
        return torch.fx.GraphModule(root, graph).forward

    def u_and_grad(self, t, X) -> tuple[np.ndarray, np.ndarray]:
        """(u (b,1), Z (b,D)) as host numpy: t (b, 1) or scalar-broadcastable,
        X (b, D)."""
        u, Z = self.u_and_grad_device(t, X)
        return u.cpu().numpy(), Z.cpu().numpy()

    def _input(self, v, cols: int) -> Tensor:
        """``v`` as a contiguous f32 (b, cols) tensor on the device; one that
        is already so is passed on without a call (each costs host time)."""
        if (isinstance(v, Tensor) and v.dtype == torch.float32 and v.device == self.device
                and v.dim() == 2 and v.shape[1] == cols and v.is_contiguous()):
            return v
        v = torch.as_tensor(v, dtype=torch.float32, device=self.device)
        return v.reshape(-1, cols).contiguous()

    def u_and_grad_device(self, t, X) -> tuple[Tensor, Tensor]:
        """(u, Z) as tensors on the device, without a host sync."""
        rows = (X.numel() if isinstance(X, Tensor) else np.size(X)) // self.dim
        with tracing.span("dnnpde.serve.request", request=next(self._requests), rows=rows):
            with tracing.span("dnnpde.serve.inputs"):
                X, t = self._input(X, self.dim), self._input(t, 1)
                if t.shape[0] != X.shape[0]:
                    t = t.expand(X.shape[0], 1).contiguous()
            with tracing.span("dnnpde.serve.graph"), torch.no_grad():
                return self._call(t, X)

    def u(self, t, X) -> np.ndarray:
        return self.u_and_grad(t, X)[0]

    def surface(self, t_values, x_points) -> np.ndarray:
        """u on the (t, x) product grid: t_values (nt,), x_points (nx, D)
        → (nt, nx), in one batched call."""
        t_values = np.asarray(t_values, np.float32).reshape(-1)
        x_points = np.asarray(x_points, np.float32).reshape(-1, self.dim)
        nt, nx = len(t_values), len(x_points)
        t = np.repeat(t_values, nx)[:, None]
        X = np.tile(x_points, (nt, 1))
        u, _ = self.u_and_grad(t, X)
        return u.reshape(nt, nx)


_FILLS = (torch.ops.aten.ones_like.default, torch.ops.aten.zeros_like.default,
          torch.ops.aten.full_like.default)


def _static(node) -> bool:
    """Whether a graph node's tensor has a shape known before any request."""
    val = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return isinstance(val, torch.Tensor) and all(isinstance(d, int) for d in val.shape)


def _pickled(node: Any) -> bool:
    """Whether a JSON record of the archive marks any entry as pickled."""
    if isinstance(node, dict):
        return bool(node.get("use_pickle")) or any(_pickled(v) for v in node.values())
    if isinstance(node, list):
        return any(_pickled(v) for v in node)
    return False


def _check_archive(blob: bytes) -> None:
    """Refuse an archive that would make ``torch.export.load`` unpickle
    anything but tensors: an entry marked pickled, or a ``.pt`` member that
    ``torch.load(weights_only=True)`` rejects (``torch.export.load`` would
    retry it with ``weights_only=False``)."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        if not any(n.endswith(_RECORD) for n in z.namelist()):
            raise ValueError("not a solution artifact of save_solution")
        for name in z.namelist():
            if name.endswith(".json") and not name.endswith(_RECORD):
                if _pickled(json.loads(z.read(name))):
                    raise ValueError(f"the artifact's {name} holds pickled objects; not loaded")
            elif name.endswith(".pt"):
                try:
                    torch.load(io.BytesIO(z.read(name)), weights_only=True)
                except Exception as e:  # any refusal of the safe unpickler
                    raise ValueError(f"the artifact's {name} holds more than tensors; "
                                     "not loaded") from e


def load_solution(path: str, device=None) -> ServedSolution:
    """Load an artifact written by :func:`save_solution` onto ``device``
    (None: the first CUDA card)."""
    from torch.export.passes import move_to_device_pass

    with tracing.span("dnnpde.serve.load"):
        device = default_device(device)
        with open(path, "rb") as f:
            blob = f.read()
        _check_archive(blob)
        extra = {_RECORD: ""}
        program = move_to_device_pass(torch.export.load(io.BytesIO(blob), extra_files=extra),
                                      device)
        return ServedSolution(program, json.loads(extra[_RECORD]), device)
