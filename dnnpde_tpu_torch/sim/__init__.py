from dnnpde_tpu_torch.sim.brownian import (
    brownian_increments,
    brownian_paths,
    time_grid,
    time_major_batch,
)

__all__ = ["brownian_increments", "brownian_paths", "time_grid", "time_major_batch"]
