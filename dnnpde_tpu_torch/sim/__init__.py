from dnnpde_tpu_torch.sim.brownian import (
    brownian_increments,
    brownian_paths,
    time_grid,
    time_major_batch,
)
from dnnpde_tpu_torch.sim.euler_maruyama import euler_maruyama, gbm_paths
from dnnpde_tpu_torch.sim.correlation import (
    CORRELATION_TYPES,
    cholesky_factor,
    generate_correlation_matrix,
    make_positive_definite,
)

__all__ = [
    "brownian_increments",
    "brownian_paths",
    "time_grid",
    "time_major_batch",
    "CORRELATION_TYPES",
    "cholesky_factor",
    "generate_correlation_matrix",
    "make_positive_definite",
    "euler_maruyama",
    "gbm_paths",
]
