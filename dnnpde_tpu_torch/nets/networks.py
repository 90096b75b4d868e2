"""Networks of the PyTorch port, the counterpart of
``dnnpde_tpu/nets/networks.py``: the plain fully-connected net (``MLP``),
the residual nets ``ResNet`` and ``NaisNet`` (``ResNet(stable=True)``) and
the leapfrog ``VerletNet``. The stochastic-depth ``SDENet`` is not ported
yet and raises NotImplementedError.

The NAIS-Net projection builds ``A = clip_F(WᵀW) + εI`` from the
``nn.Linear`` weight ``W`` (the transpose of the flax kernel ``K``, so this
is JAX's ``KKᵀ``) at every evaluation, as JAX does. Computing it once per
loss instead made the order in which autograd sums its many gradient
contributions depend on the process's history, so a captured training
iteration was not bitwise equal to an eager one the first time it ran.
"""

from __future__ import annotations

from typing import Sequence

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dnnpde_tpu_torch.nets.activations import Activation, get_activation
from dnnpde_tpu_torch.nets.initializers import xavier_uniform
from dnnpde_tpu_torch.runtime import default_device

_EPSILON = 0.01  # NAIS-Net stability margin


def _dtype(compute_dtype):
    return getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype


class Dense(nn.Module):
    """Linear layer with Xavier-uniform weights and zero bias.

    ``dtype`` is the compute dtype: input, weight and bias are cast to it
    before the product (parameters stay float32). ``generator`` draws the
    initial weights; they are then moved to ``device``. The ``nn.Linear`` is
    made without its own initialisation (``skip_init``), so building a net
    draws nothing from PyTorch's default generators.
    """

    def __init__(
        self, in_features: int, features: int,
        gain: float = 1.0, dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None, device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.utils.skip_init(nn.Linear, in_features, features, device=device)
        kernel = xavier_uniform(gain)((in_features, features), generator)
        with torch.no_grad():
            self.linear.weight.copy_(kernel.T)
            self.linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return self.linear(x)
        return F.linear(
            x.to(self.dtype), self.linear.weight.to(self.dtype), self.linear.bias.to(self.dtype)
        )


class MLP(nn.Module):
    """Plain fully-connected net: Dense+act repeated, final Dense linear.

    ``layers`` includes input and output widths, e.g. ``[D+1, 256, 256, 256,
    256, 1]``. ``compute_dtype`` (e.g. ``"bfloat16"``) is the dtype of the
    hidden matmuls; the parameters and the output head stay float32.
    """

    def __init__(
        self, layers: Sequence[int], activation: str | Activation = "sine",
        gain: float = 1.0, compute_dtype=None,
        generator: torch.Generator | None = None, device=None,
    ):
        super().__init__()
        device = default_device(device)
        self.layers = tuple(int(w) for w in layers)
        self.activation = activation
        self.act = get_activation(activation)
        self.compute_dtype = compute_dtype = _dtype(compute_dtype)
        n = len(self.layers) - 1
        self.dense = nn.ModuleList(
            Dense(self.layers[k], self.layers[k + 1], gain=gain,
                  dtype=compute_dtype if k < n - 1 else None,
                  generator=generator, device=device)
            for k in range(n)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.dense[:-1]:
            x = self.act(layer(x))
        if self.compute_dtype is not None:
            x = x.float()
        return self.dense[-1](x)


def _nais_project(weight: torch.Tensor, eps: float = _EPSILON) -> torch.Tensor:
    """NAIS-Net stability projection of a square ``nn.Linear`` weight ``W``:
    ``A = clip(WᵀW) + εI``, where the clip rescales by the Frobenius norm,
    ``WᵀW ← √δ · WᵀW / √‖WᵀW‖_F`` when ``‖WᵀW‖_F > δ = 1 − 2ε``. The clip is
    a ``torch.where`` on the device, so the projection never reads a value
    back to the host."""
    delta = 1.0 - 2.0 * eps
    rtr = weight.t() @ weight
    norm = torch.linalg.norm(rtr)
    scale = torch.where(norm > delta, math.sqrt(delta) / torch.sqrt(norm), torch.ones_like(norm))
    eye = torch.eye(rtr.shape[0], dtype=rtr.dtype, device=rtr.device)
    return rtr * scale + eps * eye


class _StableBlockDense(nn.Module):
    """Dense layer whose weight is replaced by the NAIS-Net projection ``−A``:
    ``x ↦ −x·A + b``. The projection stays f32; only the batch product takes
    the compute dtype."""

    def __init__(self, features: int, gain: float = 1.0, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.dtype = dtype
        kernel = xavier_uniform(gain)((features, features), generator)
        self.weight = nn.Parameter(kernel.T.contiguous().to(device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = _nais_project(self.weight)
        if self.dtype is not None:
            x, a = x.to(self.dtype), a.to(self.dtype)
        return -(x @ a) + self.bias


class ResNet(nn.Module):
    """Residual net; ``stable=True`` gives the NAIS-Net (input-aware stable)
    form:

      out = act(W_in x);  u = x
      for each hidden layer:  out = act(block(out) [+ U_i u]) + out
      return W_out out

    where ``block`` is a plain Dense (stable=False) or the projected ``−A``
    Dense plus an input injection ``U_i u`` (stable=True), whose hidden
    layers must then be square (ValueError otherwise, as in JAX).
    ``compute_dtype`` is the dtype of the hidden products, as in :class:`MLP`.
    """

    def __init__(
        self, layers: Sequence[int], stable: bool = True,
        activation: str | Activation = "sine", gain: float = 1.0, compute_dtype=None,
        generator: torch.Generator | None = None, device=None,
    ):
        super().__init__()
        device = default_device(device)
        self.layers = tuple(int(w) for w in layers)
        self.stable = stable
        self.activation = activation
        self.act = get_activation(activation)
        self.compute_dtype = dt = _dtype(compute_dtype)
        kw = dict(gain=gain, generator=generator, device=device)
        # creation order as flax's: the input layer, then each block (with
        # its injection), then the head; the initial weights draw in it
        self.inp = Dense(self.layers[0], self.layers[1], dtype=dt, **kw)
        blocks, inject = [], []
        for prev, width in zip(self.layers[1:-2], self.layers[2:-1]):
            if stable:
                if prev != width:
                    raise ValueError("NAIS-Net stable blocks require square hidden layers")
                blocks.append(_StableBlockDense(width, dtype=dt, **kw))
                inject.append(Dense(self.layers[0], width, dtype=dt, **kw))
            else:
                blocks.append(Dense(prev, width, dtype=dt, **kw))
        self.blocks = nn.ModuleList(blocks)
        self.inject = nn.ModuleList(inject)
        self.out = Dense(self.layers[-2], self.layers[-1], **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = x
        out = self.act(self.inp(x))
        for i, block in enumerate(self.blocks):
            shortcut = out
            if self.stable:
                out = block(out) + self.inject[i](u)
            else:
                out = block(out)
            out = self.act(out) + shortcut
        if self.compute_dtype is not None:
            out = out.float()
        return self.out(out)


class NaisNet(ResNet):
    """NAIS-Net: :class:`ResNet` with the stability projection and input
    injection (``stable=True``, the default)."""


class VerletNet(nn.Module):
    """Verlet/leapfrog two-variable residual net. Per hidden block, with the
    square kernel ``K`` (JAX layout) and bias ``b``:

      z ← z − act(out·Kᵀ + b);  out ← out + act(z·K + b)

    Hidden widths must be uniform (ValueError otherwise, as in JAX).
    ``kernels[i]`` / ``biases[i]`` are JAX's ``verlet_kernel_i`` /
    ``verlet_bias_i``."""

    def __init__(
        self, layers: Sequence[int], activation: str | Activation = "sine", gain: float = 1.0,
        compute_dtype=None, generator: torch.Generator | None = None, device=None,
    ):
        super().__init__()
        device = default_device(device)
        self.layers = tuple(int(w) for w in layers)
        self.activation = activation
        self.act = get_activation(activation)
        self.compute_dtype = dt = _dtype(compute_dtype)
        kw = dict(gain=gain, generator=generator, device=device)
        self.inp = Dense(self.layers[0], self.layers[1], dtype=dt, **kw)
        width = self.layers[1]
        if any(w != width for w in self.layers[2:-1]):
            raise ValueError("VerletNet requires uniform hidden widths")
        self.kernels = nn.ParameterList(
            nn.Parameter(xavier_uniform(gain)((width, width), generator).to(device))
            for _ in self.layers[2:-1]
        )
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(width, device=device)) for _ in self.layers[2:-1]
        )
        self.out = Dense(self.layers[-2], self.layers[-1], **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = self.act(self.inp(x))
        z = torch.zeros_like(out)
        for kernel, bias in zip(self.kernels, self.biases):
            k = kernel if dt is None else kernel.to(dt)
            shortcut = out
            out = (out if dt is None else out.to(dt)) @ k.t() + bias
            z = z - self.act(out)
            out = (z if dt is None else z.to(dt)) @ k + bias
            out = shortcut + self.act(out)
        if dt is not None:
            out = out.float()
        return self.out(out)


_MODES = {
    "fc": MLP,
    "mlp": MLP,
    "naisnet": NaisNet,
    "nais-net": NaisNet,
    "resnet": ResNet,
    "verlet": VerletNet,
    "verletnet": VerletNet,
}
_LATER_MODES = ("sdenet",)


def build_network(
    mode: str, layers: Sequence[int], activation: str | Activation = "sine",
    gain: float = 1.0, **kwargs,
) -> nn.Module:
    """Factory: network by ``mode`` string, in the reference's spellings:
    "FC"/"MLP", "Naisnet"/"NAIS-Net", "Resnet" (``stable=False``), "Verlet".
    ``kwargs`` go to the net (``compute_dtype``, ``generator``, ``device``)."""
    key = mode.lower()
    if key in _LATER_MODES:
        raise NotImplementedError(
            f"network mode {mode!r} is not ported yet (ROADMAP.md Queue 1, 'Other nets': "
            "its noise needs the solver's stochastic-net threading)"
        )
    if key not in _MODES:
        raise ValueError(
            f"Unknown network mode {mode!r}; expected one of {sorted(set(_MODES) | set(_LATER_MODES))}"
        )
    get_activation(activation)  # validate eagerly, not at the first call
    cls = _MODES[key]
    if key == "resnet":
        kwargs.setdefault("stable", False)
    return cls(layers, activation=activation, gain=gain, **kwargs)
