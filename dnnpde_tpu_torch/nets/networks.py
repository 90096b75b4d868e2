"""Networks of the PyTorch port. Only the plain fully-connected net ("FC") is
ported so far; the other modes of the JAX package raise NotImplementedError.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dnnpde_tpu_torch.nets.activations import Activation, get_activation
from dnnpde_tpu_torch.nets.initializers import xavier_uniform
from dnnpde_tpu_torch.runtime import default_device


class Dense(nn.Module):
    """Linear layer with Xavier-uniform weights and zero bias.

    ``dtype`` is the compute dtype: input, weight and bias are cast to it
    before the product (parameters stay float32). ``generator`` draws the
    initial weights; they are then moved to ``device``.
    """

    def __init__(
        self, in_features: int, features: int,
        gain: float = 1.0, dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None, device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(in_features, features, device=device)
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
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        self.compute_dtype = compute_dtype
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


_FC_MODES = ("fc", "mlp")
_LATER_MODES = ("naisnet", "nais-net", "resnet", "verlet", "verletnet", "sdenet")


def build_network(
    mode: str, layers: Sequence[int], activation: str | Activation = "sine",
    gain: float = 1.0, **kwargs,
) -> nn.Module:
    """Factory: network by ``mode`` string ("FC" or "MLP" in this port).
    ``kwargs`` go to :class:`MLP` (``compute_dtype``, ``generator``,
    ``device``)."""
    key = mode.lower()
    if key in _LATER_MODES:
        raise NotImplementedError(
            f"network mode {mode!r} is not ported yet (ROADMAP.md Queue 1, 'Other nets')"
        )
    if key not in _FC_MODES:
        raise ValueError(
            f"Unknown network mode {mode!r}; expected one of {sorted(_FC_MODES + _LATER_MODES)}"
        )
    return MLP(layers, activation=activation, gain=gain, **kwargs)
