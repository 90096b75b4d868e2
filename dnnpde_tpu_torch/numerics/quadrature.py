"""Fixed-order Gauss–Legendre quadrature, the counterpart of
``dnnpde_tpu/numerics/quadrature.py``.

The JAX package wraps its characteristic-function pricers in
``complex_safe`` because TPUs lack complex arithmetic; CUDA has it, so the
port keeps no such wrapper and integrates on the device it is given.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from dnnpde_tpu_torch.runtime import default_device


@lru_cache(maxsize=16)
def _gl_nodes(order: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(order)
    return x.astype(np.float64), w.astype(np.float64)


def gauss_legendre(f, a: float, b: float, order: int = 256, dtype=torch.float32, device=None):
    """∫_a^b f(x) dx with an order-point Gauss–Legendre rule over the last
    axis of ``f``'s values (complex allowed). ``f`` takes the nodes, an
    (order,) tensor of ``dtype`` on ``device`` (None: the first CUDA card)."""
    device = default_device(device)
    x, w = _gl_nodes(order)
    half = 0.5 * (b - a)
    mid = 0.5 * (b + a)
    nodes = torch.as_tensor(mid + half * x, dtype=dtype, device=device)
    weights = torch.as_tensor(w, dtype=dtype, device=device)
    return half * torch.sum(weights * f(nodes), dim=-1)
