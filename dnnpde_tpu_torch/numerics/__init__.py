"""Classical numerics: the ground-truth oracles ported so far (Black–Scholes
closed forms and the Monte-Carlo pricers). The rest of the JAX package's
``numerics`` is listed in ROADMAP.md, Queue 1."""

from dnnpde_tpu_torch.numerics.black_scholes import (
    basket_analytical_approx,
    black_scholes_call,
    black_scholes_delta,
    bsb_exact_solution,
    call_price_grid,
    geometric_asian_call,
    lookback_call_floating,
)
from dnnpde_tpu_torch.numerics.monte_carlo import (
    basket_call_mc,
    basket_delta_mc,
    basket_price_paths_mc,
    hjb_exact_mc,
)

__all__ = [
    "black_scholes_call",
    "black_scholes_delta",
    "geometric_asian_call",
    "lookback_call_floating",
    "call_price_grid",
    "basket_analytical_approx",
    "bsb_exact_solution",
    "basket_call_mc",
    "basket_delta_mc",
    "basket_price_paths_mc",
    "hjb_exact_mc",
]
