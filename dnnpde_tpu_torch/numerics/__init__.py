"""Classical numerics: the ground-truth oracles ported so far (Black–Scholes
closed forms and vega, the Monte-Carlo pricers, the Heston closed form, its
Milstein pricers and Crank–Nicolson solver, Gauss–Legendre quadrature,
the optimal-stopping oracles: the CRR tree and Longstaff–Schwartz with the
linear-driver probe, the discrete-N BSDE oracles, pseudo-random and
randomized QMC, the moment-matched, Carr–Madan FFT and Variance-Gamma basket
pricers, and the differentiable Heston calibration)."""

from dnnpde_tpu_torch.numerics.black_scholes import (
    basket_analytical_approx,
    black_scholes_call,
    black_scholes_delta,
    bsb_exact_solution,
    call_price_grid,
    geometric_asian_call,
    lookback_call_floating,
)
from dnnpde_tpu_torch.numerics.binomial import crr_binomial
from dnnpde_tpu_torch.numerics.calibration import CalibrationResult, calibrate_heston
from dnnpde_tpu_torch.numerics.crank_nicolson import (
    CNGrid,
    bilinear_interpolate,
    cn_delta_gamma,
    crank_nicolson_heston,
)
from dnnpde_tpu_torch.numerics.discrete_bsde import (
    DiscreteBSDEValue,
    discrete_bsde_surface,
    discrete_bsde_value,
    probe_linear_driver,
)
from dnnpde_tpu_torch.numerics.fft_pricer import (
    basket_lognormal_cf_params,
    carr_madan_call,
    fft_basket_call,
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
from dnnpde_tpu_torch.numerics.implied_vol import bs_vega, implied_vol
from dnnpde_tpu_torch.numerics.longstaff_schwartz import LSMCValue, basis_size, lsmc_value
from dnnpde_tpu_torch.numerics.moments import (
    basket_moments,
    match_lognormal,
    moment_matched_basket_call,
)
from dnnpde_tpu_torch.numerics.monte_carlo import (
    basket_call_mc,
    basket_delta_mc,
    basket_price_paths_mc,
    hjb_exact_mc,
)
from dnnpde_tpu_torch.numerics.qmc import (
    QMCValue,
    brownian_bridge_order,
    discrete_bsde_value_qmc,
    sobol_brownian_increments,
)
from dnnpde_tpu_torch.numerics.quadrature import gauss_legendre
from dnnpde_tpu_torch.numerics.variance_gamma import (
    VGParams,
    vg_basket_call,
    vg_table_2,
    vg_table_3,
)

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
    "bs_vega",
    "implied_vol",
    "crr_binomial",
    "DiscreteBSDEValue",
    "discrete_bsde_surface",
    "discrete_bsde_value",
    "probe_linear_driver",
    "QMCValue",
    "brownian_bridge_order",
    "discrete_bsde_value_qmc",
    "sobol_brownian_increments",
    "LSMCValue",
    "basis_size",
    "lsmc_value",
    "CalibrationResult",
    "calibrate_heston",
    "basket_lognormal_cf_params",
    "carr_madan_call",
    "fft_basket_call",
    "basket_moments",
    "match_lognormal",
    "moment_matched_basket_call",
    "VGParams",
    "vg_basket_call",
    "vg_table_2",
    "vg_table_3",
]
