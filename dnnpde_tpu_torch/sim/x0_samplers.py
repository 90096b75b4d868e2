"""Initial-state samplers: train the solution surface, not one point, the
counterpart of ``dnnpde_tpu/sim/x0_samplers.py``.

Pass one to ``Trainer(x0_sampler=...)``: every training iteration then
draws a fresh batch of initial states on the device, from the trainer's
generator, instead of broadcasting ``problem.x0``. A sampler is called as
``sample(generator, M) -> (M, D)`` and draws on the generator's device (the
JAX samplers take a key in place of the generator).

Both samplers are mean-preserving around ``x0``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dnnpde_tpu_torch.runtime import OnDevice

Tensor = torch.Tensor
X0Sampler = Callable[[torch.Generator, int], Tensor]


def _f32(a) -> Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).reshape(-1)


def lognormal_x0(x0, scale) -> X0Sampler:
    """Multiplicative lognormal jitter for strictly positive states:
    ``X0 = x0 · exp(scale·Z − scale²/2)`` with Z ~ N(0, I), so E[X0] = x0
    and X0 > 0. ``scale`` is the log-space standard deviation, a scalar or a
    length-D vector of per-coordinate spreads."""
    x0 = OnDevice(_f32(x0))
    scale_cpu = _f32(scale)
    D = x0.value.shape[0]
    if scale_cpu.shape[0] not in (1, D):
        raise ValueError(f"scale must be scalar or length {D}, got shape {tuple(scale_cpu.shape)}")
    if not bool(torch.all(scale_cpu > 0.0)):
        raise ValueError(f"scale must be positive, got {scale_cpu}")
    scale = OnDevice(scale_cpu)
    shift = OnDevice(0.5 * scale_cpu**2)

    def sample(generator: torch.Generator, M: int) -> Tensor:
        dev = generator.device
        z = torch.randn((M, D), generator=generator, dtype=torch.float32, device=dev)
        return x0.on(dev)[None, :] * torch.exp(scale.on(dev)[None, :] * z - shift.on(dev)[None, :])

    return sample


def gaussian_x0(x0, scale: float) -> X0Sampler:
    """Additive Gaussian jitter ``X0 = x0 + scale·Z`` for unconstrained
    states (e.g. HJB's ℝ^D state)."""
    x0 = OnDevice(_f32(x0))
    if float(scale) <= 0.0:
        raise ValueError(f"scale must be positive, got {scale}")
    D = x0.value.shape[0]

    def sample(generator: torch.Generator, M: int) -> Tensor:
        dev = generator.device
        z = torch.randn((M, D), generator=generator, dtype=torch.float32, device=dev)
        return x0.on(dev)[None, :] + scale * z

    return sample
