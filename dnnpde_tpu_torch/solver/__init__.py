from dnnpde_tpu_torch.solver.bsde import (
    RolloutResult,
    SolverConfig,
    make_loss_fn,
    make_net_u,
    make_path_loss_fn,
)

__all__ = [
    "RolloutResult",
    "SolverConfig",
    "make_loss_fn",
    "make_net_u",
    "make_path_loss_fn",
]
