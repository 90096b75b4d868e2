"""Weight initialisation: Xavier-uniform with an explicit gain and generator."""

from __future__ import annotations

from typing import Callable

import torch


def xavier_uniform(gain: float = 1.0) -> Callable[..., torch.Tensor]:
    """Xavier/Glorot uniform, bound = gain * sqrt(6/(fan_in+fan_out)), for a
    kernel of shape (fan_in, fan_out) in the JAX layout.

    The returned ``init(shape, generator=None, dtype=torch.float32)`` draws on
    the generator's device."""

    def init(shape, generator: torch.Generator | None = None, dtype=torch.float32):
        if len(shape) < 2:
            raise ValueError("xavier_uniform requires >=2D shapes")
        fan_in, fan_out = shape[-2], shape[-1]
        bound = gain * (6.0 / (fan_in + fan_out)) ** 0.5
        device = generator.device if generator is not None else None
        u = torch.rand(tuple(shape), generator=generator, dtype=dtype, device=device)
        return (2.0 * u - 1.0) * bound

    return init
