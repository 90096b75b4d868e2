"""Activation functions, selected by case-insensitive name
({"Sine", "ReLU", "Tanh"}), as in the JAX package."""

from __future__ import annotations

from typing import Callable

import torch

Activation = Callable[[torch.Tensor], torch.Tensor]


def sine(x: torch.Tensor) -> torch.Tensor:
    """Sine activation (SIREN-style)."""
    return torch.sin(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0), with JAX's ``jnp.maximum`` derivative at the tie x = 0
    (½, where ``torch.clamp`` gives 1 and ``torch.relu`` 0): a NAIS-Net
    with zero biases sees exact zeros at the HJB's x0 = 0."""
    return torch.maximum(x, x.new_zeros(()))


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


_ACTIVATIONS: dict[str, Activation] = {
    "sine": sine,
    "relu": relu,
    "tanh": tanh,
}


def get_activation(name: str | Activation) -> Activation:
    """Resolve an activation by (case-insensitive) name or pass through a callable."""
    if callable(name):
        return name
    key = name.lower()
    if key not in _ACTIVATIONS:
        raise ValueError(
            f"Unknown activation {name!r}; expected one of {sorted(_ACTIVATIONS)}"
        )
    return _ACTIVATIONS[key]
