from dnnpde_tpu_torch.sim.brownian import (
    brownian_increments,
    brownian_paths,
    paths_to_increments,
    time_grid,
    time_major_batch,
)
from dnnpde_tpu_torch.sim.x0_samplers import X0Sampler, gaussian_x0, lognormal_x0
from dnnpde_tpu_torch.sim.euler_maruyama import euler_maruyama, gbm_paths
from dnnpde_tpu_torch.sim.mlmc import (
    MLMCConfig,
    coupled_brownian_increments,
    mlmc_gbm_price,
    mlmc_minibatch,
)
from dnnpde_tpu_torch.sim.correlation import (
    CORRELATION_TYPES,
    cholesky_factor,
    generate_correlation_matrix,
    make_positive_definite,
)

__all__ = [
    "brownian_increments",
    "brownian_paths",
    "paths_to_increments",
    "time_grid",
    "time_major_batch",
    "CORRELATION_TYPES",
    "cholesky_factor",
    "generate_correlation_matrix",
    "make_positive_definite",
    "euler_maruyama",
    "gbm_paths",
    "MLMCConfig",
    "coupled_brownian_increments",
    "mlmc_gbm_price",
    "mlmc_minibatch",
    "X0Sampler",
    "gaussian_x0",
    "lognormal_x0",
]
