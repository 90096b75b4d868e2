"""Classical numerics: the ground-truth oracles ported so far (Black–Scholes
closed forms, the Monte-Carlo pricers, the Heston closed form, its Milstein
pricers and Crank–Nicolson solver, and Gauss–Legendre quadrature). The rest
of the JAX package's ``numerics`` is listed in ROADMAP.md, Queue 1."""

from dnnpde_tpu_torch.numerics.black_scholes import (
    basket_analytical_approx,
    black_scholes_call,
    black_scholes_delta,
    bsb_exact_solution,
    call_price_grid,
    geometric_asian_call,
    lookback_call_floating,
)
from dnnpde_tpu_torch.numerics.crank_nicolson import (
    CNGrid,
    bilinear_interpolate,
    cn_delta_gamma,
    crank_nicolson_heston,
)
from dnnpde_tpu_torch.numerics.heston import (
    HestonParams,
    heston_call_price,
    heston_delta_surface,
    heston_gamma_surface,
    heston_mc_price,
    heston_mc_price_ii,
    heston_price_surface,
)
from dnnpde_tpu_torch.numerics.monte_carlo import (
    basket_call_mc,
    basket_delta_mc,
    basket_price_paths_mc,
    hjb_exact_mc,
)
from dnnpde_tpu_torch.numerics.quadrature import gauss_legendre

__all__ = [
    "black_scholes_call",
    "black_scholes_delta",
    "geometric_asian_call",
    "lookback_call_floating",
    "call_price_grid",
    "basket_analytical_approx",
    "bsb_exact_solution",
    "CNGrid",
    "crank_nicolson_heston",
    "bilinear_interpolate",
    "cn_delta_gamma",
    "HestonParams",
    "heston_call_price",
    "heston_price_surface",
    "heston_delta_surface",
    "heston_gamma_surface",
    "heston_mc_price",
    "heston_mc_price_ii",
    "basket_call_mc",
    "basket_delta_mc",
    "basket_price_paths_mc",
    "hjb_exact_mc",
    "gauss_legendre",
]
