from dnnpde_tpu_torch.solver.bsde import (
    RolloutResult,
    SolverConfig,
    make_loss_fn,
    make_net_u,
    make_path_loss_fn,
)
from dnnpde_tpu_torch.solver.weights import iv_space_weights

__all__ = [
    "RolloutResult",
    "SolverConfig",
    "iv_space_weights",
    "make_loss_fn",
    "make_net_u",
    "make_path_loss_fn",
]
